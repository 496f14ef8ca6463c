"""Data pipeline: synthetic corpora + group-sharded batch iterators
(counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import GroupBatchIterator, make_batch_iterator

__all__ = ["GroupBatchIterator", "make_batch_iterator"]
