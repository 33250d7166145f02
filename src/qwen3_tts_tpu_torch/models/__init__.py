"""Model components: layers, talker, code predictor, rvq codec."""
