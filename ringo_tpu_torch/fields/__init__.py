from .spec import (  # noqa: F401
    DIGIT_BITS, DIGIT_BASE, DIGIT_MASK,
    FieldSpec, find_modulus, derive_base_exp, is_probable_prime,
    ZP255, ZP110, ZP220, ZP440, ZP880, ZP128, ZP240, REFERENCE_FIELDS,
)
from .field_ops import FieldOps  # noqa: F401
from . import limb  # noqa: F401
