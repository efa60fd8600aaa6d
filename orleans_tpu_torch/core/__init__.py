"""Identity and hashing (the port's copy of the part of
``orleans_tpu.core`` that the device tier needs)."""

from .ids import (  # noqa: F401
    GrainCategory,
    GrainId,
    GrainType,
    stable_hash32,
    stable_hash64,
    type_code_of,
)
