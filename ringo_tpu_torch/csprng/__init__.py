from .uniform import UniformSampler  # noqa: F401
from .gaussian import (  # noqa: F401
    RoundedGaussianSampler, TwinCDTGaussianSampler, COSACSampler, compute_cdt,
)
