"""PyTorch/CUDA port of `gea` for NVIDIA Hopper (H100).

The JAX package `gea/` stays the reference; this package imports nothing of
it (nor JAX). Ported so far: the serving path (the G-LIS generator renders
every LIS stage, the discriminator scores the final stage and the top-k by
score is kept, `gea_torch.serve.ServingModel`), the G-LIS alternating
train step (`gea_torch.train`) and its trainer, `python -m
gea_torch.cli.train_glis` (`gea_torch.data`, `gea_torch.train.runner`,
`gea_torch.utils`), and the two reverser trainers, `python -m
gea_torch.cli.train_r_separate` and `train_r_iterative`
(`gea_torch.models.reverter`, `gea_torch.train.steps_r`), and evaluation:
`gea`'s proxy-FID, KID and precision/recall (`gea_torch.eval.fid`), FID
tracking in the three trainers (`--fid_interval`) and the evaluators
`python -m gea_torch.cli.compute_fid`, `eval_stages` and `eval_chain`,
the samplers, and export and serving: `python -m
gea_torch.cli.export_model` writes a `torch.export` artifact that
`gea_torch.serve.load` serves (`python -m gea_torch.serve`, and the HTTP
server `gea_torch.serve_http`). Their three TPU kernels are hand-written
Hopper kernels in `gea_torch.ops`, each a `torch.library` custom op behind
a `torch.autograd.Function`. The trainers and the serving path run
data-parallel over several cards (`gea_torch.parallel`).

Entry points run on CUDA unless the caller passes `device="cpu"`; on the CPU
every kernel runs its plain PyTorch version.
"""

from gea_torch.config import FLAGSHIP, ModelConfig  # noqa: F401
