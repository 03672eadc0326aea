from gea_torch.models.discriminator import Discriminator, DiscriminatorTrunk  # noqa: F401
from gea_torch.models.generator import (  # noqa: F401
    GeneratorCore,
    GeneratorLIS,
    LISModule,
)
from gea_torch.models.reverter import Reverter  # noqa: F401
