from .pipeline import DatasetSpec, Loader, stage_in, write_corpus
from .synthetic import batch_for_step, token_block

__all__ = ["DatasetSpec", "Loader", "stage_in", "write_corpus",
           "batch_for_step", "token_block"]
