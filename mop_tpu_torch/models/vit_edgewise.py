"""ViTEdgewise re-export (canonical home: ``mop_tpu_torch.models.vit_variants``)."""

from .vit_variants import ViTEdgewise

__all__ = ["ViTEdgewise"]
