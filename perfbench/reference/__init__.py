"""The plain reference of the served model, in float32 PyTorch: the shared
blocks here, and each model family's ``reference.py``
(``perfbench/families/<family>/``) over them.

It imports nothing of the program under test and nothing of JAX. It reads
the raw weights that the benchmark made (a family's ``weights.py``), the same
tensors the program was handed, and works out everything else again: the
dequantized weights, the prompt rows, the trailing text, the RoPE tables.
It runs teacher-forced over a served request (prompt, then every frame the
program served) and returns the logits that judge each served token, and
the waveform that judges the served PCM.

``precision`` turns the same code into the control: each weight one step
below its stated precision and activations in bfloat16 (``quant.py``).
"""
