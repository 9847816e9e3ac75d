"""TERRA-GAN on PyTorch and CUDA: the port of terra_gan_tpu to one NVIDIA H100.

The JAX package ``terra_gan_tpu`` is the reference this package is held
against; this one imports ``torch`` and never ``jax``. Public functions
take NHWC tensors ([B, H, W, C], masks [B, H, W, 1]) as the JAX package
does, and parameters use the reference's torch state-dict keys, so a
``.pth`` written by either package loads in the other.

Layout (mirrors the JAX package's names):
  ops/          partial conv and resampling in plain PyTorch; ops/cuda/
                holds the hand-written kernels (sources in csrc/), each
                beside its plain version and a launch count
  models/       PConvUNet generator (eval and train mode), Big-LaMa's
                FFC ResNet generator (models/lama.py), PatchGAN
                discriminator, VGG16 features[:16] for the loss
  losses/       the reference inpainting loss
  training/     train state, the fused G+D step, .pth checkpoints, the
                epoch loop
  data/         tile datasets and the prefetching batch loader, the
                per-grid directory layout, the DSM colorizer
  config.py     the JAX package's typed config schema, read with
                utils/yaml_lite.py (no PyYAML), and the loop's LoopConfig
  cli/          the pipeline CLI (evaluate), the doctor, the probe run
  parallel/     BatchedInpainter: pinned, pipelined batched inference
  evaluation/   evaluate / inpaint_directory and their host helpers
  utils/        device resolution, weights carried across packages,
                the YAML reader

Kernels build with nvcc from csrc/ at their first CUDA call.
"""

__version__ = "0.1.0"
