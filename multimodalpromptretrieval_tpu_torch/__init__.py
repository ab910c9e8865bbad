"""PyTorch + CUDA port of Multimodal Prompt Retrieval (MPR_Gen) for Hopper.

A second package beside the JAX reference ``multimodalpromptretrieval_tpu``,
with the same module layout and names so that each module's counterpart is
easy to find. It imports ``torch`` and never ``jax``. Host-only modules of
the JAX package that never import jax (``text/``, ``native/``,
``data/batching.bucket_width`` / ``pad_rows``, ``data/synthetic``) are
shared by import.

Layout:
  ops/        plain tensor layers, and the four kernels of the serving path
              (row attention, LayerNorm, RMSNorm, L2 top-k), each next to
              its plain PyTorch version; ``_build`` compiles ``csrc/``.
  csrc/       CUDA C++ sources for sm_90a (built with nvcc at first use).
  models/     CLIP towers, T5 encoder + greedy decode, MPR_Gen prefix model.
  retrieval/  device-resident retrieval index and pre-tokenized hint tables.
  bridge.py   JAX params pytree / npz checkpoint -> the port's modules.
  serve.py    MPRServer: staged images, fused serve chunk, host-prompt path.
  serving.py  config -> model, tokenizers and retrieval index for serving.

Every kernel wrapper dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
