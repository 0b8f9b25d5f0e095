"""Data for the port: the CIFAR pickles, a synthetic set, batch iterators and
the native prefetching loader."""

from .cifar import (BatchIterator, download_cifar, eval_batches, has_real_data, load_cifar,
                    synthetic_cifar, train_val_split)

__all__ = [
    "load_cifar",
    "synthetic_cifar",
    "has_real_data",
    "download_cifar",
    "train_val_split",
    "BatchIterator",
    "eval_batches",
]
