"""Synthetic data and partitioning (pure numpy, shared seeds with the reference)."""

from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import (
    HousingData,
    make_housing_data,
    make_lm_data,
    LMDataIterator,
)

__all__ = [
    "dirichlet_partition",
    "iid_partition",
    "HousingData",
    "make_housing_data",
    "make_lm_data",
    "LMDataIterator",
]
