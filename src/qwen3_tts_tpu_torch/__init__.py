"""qwen3-tts-tpu, ported to PyTorch and CUDA (NVIDIA Hopper, sm_90a).

The same sub-package layout as ``qwen3_tts_tpu`` (engine/, models/, ops/,
runtime/, audio/), so each module's counterpart is found by its path. This
package imports torch and numpy only: nothing of JAX and nothing of the JAX
package, which stays the reference it is tested against.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; every int8 linear runs on one of two hand-written CUDA
kernels there (``ops/``, sources in ``csrc/``).

    from qwen3_tts_tpu_torch.engine import load_model, generate_audio
    model = load_model("synthetic:flagship")           # on the GPU
    generate_audio(model=model, text="Hello.", voice="ryan", output_path="out")
"""
