"""The eval step of the PyTorch port, on one device."""

from .train_step import cast_floats, make_classifier_eval_step

__all__ = ["cast_floats", "make_classifier_eval_step"]
