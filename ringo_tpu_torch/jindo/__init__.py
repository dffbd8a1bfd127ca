from .params import Parameters, new_parameters, find_msis_rank  # noqa: F401
from .entities import (  # noqa: F401
    CommitKey, Commitment, Opening, Proof, commit_key_from_arrays,
)
from .challenge import encode_challenge, left_vec, right_vec  # noqa: F401
from .encoder import Encoder  # noqa: F401
from .prover import Prover, sample_field_digits  # noqa: F401
from .verifier import Verifier  # noqa: F401
