"""Deterministic synthetic data (copy of ``repro/data``, numpy only)."""
from repro_torch.data.synthetic import (SyntheticImages, TokenStream,
                                        make_image_batch, make_lm_batch)

__all__ = ["SyntheticImages", "TokenStream", "make_lm_batch",
           "make_image_batch"]
