from .spec import (  # noqa: F401
    DIGIT_BITS, DIGIT_BASE, DIGIT_MASK, FieldSpec, is_probable_prime,
    ZP255, ZP110, ZP220, ZP440, ZP880, ZP128, ZP240, REFERENCE_FIELDS,
)
from . import limb  # noqa: F401
