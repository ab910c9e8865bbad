"""PyTorch + CUDA port of Multimodal Prompt Retrieval (MPR_Gen) for Hopper.

A second package beside the JAX reference ``multimodalpromptretrieval_tpu``,
with the same module layout and names so that each module's counterpart is
easy to find. It imports ``torch``, never ``jax``, and nothing of the JAX
package: the host-only modules it needs (``text/``, ``native/``,
``data/batching``, ``data/synthetic``, ``data/datasets``,
``data/roco_questions``, ``train/metrics``, ``utils.get_model_prefix``)
are its own copies. Its
entry points run on the card unless called with ``device="cpu"``.

Layout:
  ops/        plain tensor layers, and the nine kernels (row attention over
              packed rows and over q / k / v, LayerNorm, RMSNorm, L2 top-k,
              two decode-step attentions, flash attention, short
              attention), each next to its plain PyTorch version; the row
              attentions and the norms are differentiable
              (``torch.autograd.Function``); ``_build`` compiles ``csrc/``;
              CLIP image preprocessing (``image``).
  csrc/       CUDA C++ sources for sm_90a (built with nvcc at first use).
  models/     CLIP towers, T5 encoder, teacher-forced decoder, loss and
              greedy decode, the MPR_Gen model and its variants (text-only,
              prediction head, BAN with the fusion of ``models/ban.py``),
              their losses and predictions.
  retrieval/  device-resident retrieval index and pre-tokenized hint tables.
  text/, native/, data/   tokenizers (Python and C++), batching, the
              dataset parsers, the preprocessed-image cache, the synthetic
              SLAKE corpus, the ROCO question generator.
  train/      AdamW + ReduceLROnPlateau, the dropout generator, the device
              steps (one process or data-parallel), checkpoints in the JAX
              npz format, the test metrics, TrainingExperiment (train,
              test) and run_from_config, the --eval attention heat maps
              (visualize), torch.profiler traces and step timing
              (profiling).
  parallel/   the torch.distributed process group (multihost), data
              parallelism and the ``parallelism`` config key (mesh), the
              index-sharded L2 top-k (retrieval).
  ops/flops   the matmul FLOP counts of each component.
  cli.py      the command line: --train / --resume / --test / --serve /
              --eval, and the process-group flags.
  bridge.py   JAX params / AdamW pytrees <-> the port's modules.
  serve.py    MPRServer: staged images, fused serve chunk, host-prompt
              path, the variants' per-batch path.
  serving.py  config -> model, tokenizers and retrieval index for serving.
  kernel_check.py, profile_serve.py, profile_train.py   on-card checks and
              time breakdowns.

Every kernel wrapper dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
