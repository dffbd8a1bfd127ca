from .params import Parameters, new_parameters, find_msis_rank  # noqa: F401
from .entities import (  # noqa: F401
    CommitKey, Commitment, Opening, Proof, commit_key_from_arrays,
)
from .encoder import Encoder  # noqa: F401
from .prover import Prover, sample_field_digits  # noqa: F401
from .verifier import Verifier  # noqa: F401
