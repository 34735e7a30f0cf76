"""Synthetic data (``repro.data`` counterparts)."""
from repro_torch.data.synthetic import (SyntheticLM, frontend_batches,
                                        lm_batches, zipf_tokens)

__all__ = ["SyntheticLM", "lm_batches", "frontend_batches", "zipf_tokens"]
