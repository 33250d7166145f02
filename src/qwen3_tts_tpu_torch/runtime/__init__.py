"""Runtime: prompts, sampling and the synthesis loop (``generate``)."""
