"""The plain reference of what the benchmark's cells run: G-LIS's generator
and discriminator as functions of a dict of parameters, the BCE losses,
Adam, the alternating train step, the render of the final stage, D's
score, the uint8 conversion, the top-k choice, and the synthetic input
batches. Plain PyTorch in fp32 with TF32 off; imports neither `gea` nor
`gea_torch`, and takes no weight, table or state that the program made.

The parameter names are those of the port's modules
(`project.weight_v`, `lis.0.fc1.bias`, `trunk.downs.1.act.a`, ...), so
that the benchmark can hand one dict of weights to both sides.

`Numerics` selects the arithmetic of the products: exact fp32, or the
control's fp8 (e4m3 with a per-tensor scale on every operand of every
product, forward and backward), the step below the configuration's bf16.
"""

from portbench.reference.glis import (  # noqa: F401
    Adam,
    Numerics,
    discriminator,
    exact_fp32,
    generator,
    render_final,
    score,
    stage_weights,
    to_uint8,
    top_k,
    train_steps,
)
from portbench.reference.data import synthetic_reals  # noqa: F401
