"""The train and eval steps of the PyTorch port, on one device."""

from .train_step import (cast_floats, make_classifier_eval_step, make_classifier_train_step,
                         make_imagenet_train_step, make_lm_train_step,
                         make_scanned_classifier_train_step)

__all__ = ["cast_floats", "make_classifier_eval_step", "make_classifier_train_step",
           "make_imagenet_train_step", "make_lm_train_step",
           "make_scanned_classifier_train_step"]
