"""Data for the port: the CIFAR pickles, a synthetic set, batch iterators and
the native prefetching loader; VOC boxes and ImageNet folders, each with its
synthetic set; the text tokenizers (byte-level BPE, characters)."""

from .cifar import (BatchIterator, download_cifar, eval_batches, has_real_data, load_cifar,
                    synthetic_cifar, train_val_split)
from .tokenizer import ByteBPETokenizer, CharTokenizer
from .imagenet import has_imagefolder, load_imagefolder, synthetic_imagenet, val_test_split
from .voc import has_real_voc, load_voc_boxes, synthetic_voc

__all__ = [
    "load_cifar",
    "synthetic_cifar",
    "has_real_data",
    "download_cifar",
    "train_val_split",
    "BatchIterator",
    "eval_batches",
    "has_real_voc",
    "load_voc_boxes",
    "synthetic_voc",
    "has_imagefolder",
    "load_imagefolder",
    "synthetic_imagenet",
    "val_test_split",
    "ByteBPETokenizer",
    "CharTokenizer",
]
