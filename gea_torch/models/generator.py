"""G-LIS generator (port of `gea/models/generator.py`).

A chain of `r_iterations` LIS modules refines the code, z_{i+1} = z_i +
MLP(z_i); every stage's code is stacked into one S*B batch and rendered by
one conv-transpose core (`render_final` renders the final code alone, as a
batch of B). Params are fp32, compute runs in `cfg.dtype`.

Kernels on this path (each with its plain PyTorch twin, chosen by
`use_kernels=False`):

* every LIS link -> `gea_torch.ops.lis.lis_residual_mlp`; where gradients
  are recorded, the links run as one `gea_torch.ops.lis.lis_chain`, whose
  backward is one kernel call for the whole chain;
* the seed segment `project -> project_act -> up1` -> `gea_torch.ops.seed.
  fused_seed` (the `fused_seed=True` configuration of `gea`), for d >= 2
  and `norm` weight or none: `gea` turns the fused seed off under batch
  norm, whose statistics need the whole projected batch, so the seed then
  runs as project -> BatchNorm -> LeakyReLU -> conv-transpose;
* every activation after a conv outside the seed kernel (`up1_act`..) ->
  `gea_torch.ops.tprelu.fused_tprelu` (after the batch norm under
  `norm=batch`, as LeakyReLU(0.2)).

Under `norm=batch` the S stages render as one S*B batch, so the batch
statistics run over all S*B images, as in `gea`.

`gea`'s `subpixel_mode` and `rgb_pad` are XLA lowering knobs and are not
ported. The module and parameter names are those of `TorchGeneratorLIS` in
`gea/interop/torch_port.py`, so its state_dicts load here unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from gea_torch.config import ModelConfig, generator_plan, resolve_device
from gea_torch.ops.layers import ConvTranspose, Dense, TPReLU, eval_mode, norm_act
from gea_torch.ops.lis import lis_chain, lis_residual_mlp, lis_residual_mlp_plain
from gea_torch.ops.seed import fused_seed, fused_seed_plain


class LISModule(nn.Module):
    """One learned-input-space residual block: z + MLP(z), as one kernel.
    Its activation is a learned TPReLU under weight norm, else
    LeakyReLU(0.2) (batch norm included: `gea`'s LIS has no batch norm)."""

    def __init__(self, code_size: int, hidden_mult: int = 1, norm: str = "weight",
                 use_kernels: bool = True):
        super().__init__()
        wn = norm == "weight"
        hidden = code_size * hidden_mult
        self.use_kernels = use_kernels
        self.fc1 = Dense(code_size, hidden, wn)
        self.act = TPReLU(hidden, learned=wn, use_kernels=use_kernels)
        self.fc2 = Dense(hidden, code_size, wn)

    def kernel_args(self, z: torch.Tensor) -> tuple:
        """The link's arguments (z, w1, b1, slope, trans, w2, b2). Weights
        reach the kernels row-major in z's dtype: the cast writes them so,
        and the kernel wrappers copy nothing."""
        dt = z.dtype
        return (
            z,
            self.fc1.normalized_weight().t().to(dt, memory_format=torch.contiguous_format),
            self.fc1.bias,
            self.act.a,
            self.act.b,
            self.fc2.normalized_weight().t().to(dt, memory_format=torch.contiguous_format),
            self.fc2.bias,
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        op = lis_residual_mlp if self.use_kernels else lis_residual_mlp_plain
        return op(*self.kernel_args(z))


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, use_kernels: bool):
        super().__init__()
        self.conv = ConvTranspose(cin, cout, norm == "weight")
        self.act = norm_act(norm, cout, use_kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))


class GeneratorCore(nn.Module):
    """The conv-transpose rendering core: codes (N, code) -> NHWC images in
    [-1, 1], in the codes' dtype."""

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True):
        super().__init__()
        wn = cfg.norm == "weight"
        self.cfg = cfg
        self.use_kernels = use_kernels
        s0, d = generator_plan(cfg.image_size)
        self.s0, self.d = s0, d
        self.seed_kernel = d >= 2 and cfg.norm != "batch"
        nf, cap = cfg.num_features, cfg.max_features
        self.c0 = min(nf * 2 ** (d - 1), cap)
        self.project = Dense(cfg.code_size, s0 * s0 * self.c0, wn)
        self.project_act = norm_act(cfg.norm, self.c0, use_kernels)
        ups, ch = [], self.c0
        for i in range(1, d):
            ci = min(nf * 2 ** (d - 1 - i), cap)
            cin = ch + (cfg.spatial_code if i == 2 else 0)
            ups.append(UpBlock(cin, ci, cfg.norm, use_kernels))
            ch = ci
        self.ups = nn.ModuleList(ups)
        rgb_in = ch + (cfg.spatial_code if d == 2 else 0)
        self.to_rgb = ConvTranspose(rgb_in, 3, wn)

    def _seed(self, z: torch.Tensor) -> torch.Tensor:
        """project -> project_act -> up1 in one kernel: (N, 2s0, 2s0, c1)."""
        up1 = self.ups[0].conv
        op = fused_seed if self.use_kernels else fused_seed_plain
        dt = z.dtype
        return op(
            z,
            self.project.normalized_weight().t().to(dt, memory_format=torch.contiguous_format),
            self.project.bias,
            self.project_act.a,
            self.project_act.b,
            up1.hwio_weight().to(dt, memory_format=torch.contiguous_format),
            up1.bias,
            self.s0,
        )

    def core(self, z: torch.Tensor, spatial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.seed_kernel:
            x = self.ups[0].act(self._seed(z))
        else:
            x = self.project(z).view(z.shape[0], self.s0, self.s0, self.c0)
            x = self.project_act(x)
            if self.d >= 2:
                x = self.ups[0](x)
        if self.cfg.spatial_code > 0:
            if spatial_noise is None:
                raise ValueError(
                    "spatial_code > 0 requires a spatial_noise input of shape "
                    f"(N, {2 * self.s0}, {2 * self.s0}, {self.cfg.spatial_code})"
                )
            if self.d >= 2:
                x = torch.cat([x, spatial_noise.to(x.dtype)], dim=-1)
        for up in self.ups[1:]:
            x = up(x)
        # tanh in the compute dtype, as gea keeps its stage buffer in bf16.
        return torch.tanh(self.to_rgb(x))


class GeneratorLIS(GeneratorCore):
    """Full G-LIS generator: the LIS chain plus the shared core. The core's
    layers sit at the top level of the module (as in `TorchGeneratorLIS`),
    so this class extends the core rather than holding it."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 use_kernels: bool = True):
        dev = resolve_device(device)
        super().__init__(cfg, use_kernels)
        hidden_mult = cfg.lis_hidden_mult
        self.lis = nn.ModuleList(
            LISModule(cfg.code_size, hidden_mult, cfg.norm, use_kernels)
            for _ in range(cfg.r_iterations)
        )
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.project.bias.device

    def spatial_noise_shape(self, batch: int) -> Optional[Tuple[int, ...]]:
        if self.cfg.spatial_code == 0:
            return None
        return (batch, 2 * self.s0, 2 * self.s0, self.cfg.spatial_code)

    def forward(
        self,
        z: torch.Tensor,
        spatial_noise: Optional[torch.Tensor] = None,
        render_all_stages: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z (B, code) -> (images (S, B, H, W, 3) in the compute dtype,
        zs (r_iterations + 1, B, code) in fp32)."""
        dt = self.cfg.torch_dtype
        batch = z.shape[0]
        zs: List[torch.Tensor] = [z]
        x = z.to(dt)
        if self.use_kernels and torch.is_grad_enabled() and len(self.lis):
            # One backward call for the chain; exported (no_grad) and plain
            # graphs keep one node a link.
            zs += lis_chain(x, [m.kernel_args(x)[1:] for m in self.lis])
        else:
            for m in self.lis:
                x = m(x)
                zs.append(x)
        if not self.lis:
            render = zs[:1]
        elif render_all_stages or self.cfg.include_initial_image:
            render = zs
        else:
            render = zs[1:]
        stacked = torch.cat([t.to(dt) for t in render], dim=0)  # (S*B, code)
        sn = None
        if self.cfg.spatial_code > 0:
            if spatial_noise is None:
                raise ValueError("spatial_code > 0 requires spatial_noise")
            sn = spatial_noise.repeat(len(render), 1, 1, 1)
        images = self.core(stacked, sn)
        images = images.reshape(len(render), batch, *images.shape[1:])
        return images, torch.stack([t.float() for t in zs])

    def render(
        self, z: torch.Tensor, spatial_noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render every stage (z0..zN) in inference mode (batch norm on its
        running statistics, as `gea`'s `render` applies train=False; the
        module's mode is put back); images in fp32."""
        with eval_mode(self):
            images, zs = self(z, spatial_noise, render_all_stages=True)
        return images.float(), zs

    def render_final(
        self, z: torch.Tensor, spatial_noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final stage of `render` alone, for callers that keep no other:
        the chain runs on every code, then the core renders zs[-1] as a batch
        of B (the spatial noise not repeated). Images (1, B, H, W, 3) in
        fp32, zs as `render`'s."""
        dt = self.cfg.torch_dtype
        with eval_mode(self):
            zs: List[torch.Tensor] = [z]
            x = z.to(dt)
            for m in self.lis:
                x = m(x)
                zs.append(x)
            images = self.core(zs[-1].to(dt), spatial_noise)
        return images.float().unsqueeze(0), torch.stack([t.float() for t in zs])
