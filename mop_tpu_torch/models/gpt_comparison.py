"""The GPT comparison framework, Baseline vs Quartet vs MoP, in PyTorch: the
port of ``mop_tpu/models/gpt_comparison.py``.

``build_models`` builds the three LMs on the ``meta`` device, which counts
their parameters without allocating weights; ``init_params`` materialises
them on the framework's device (the GPU unless given) from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .gpt_mop import create_gpt_baseline, create_gpt_mop, create_gpt_quartet
from .quartet_attn_patch import TransformerConfig


@dataclass
class ComparisonConfig:
    """The reference comparison config."""

    n_layer: int = 8
    n_head: int = 8
    n_embd: int = 640
    dropout: float = 0.1
    block_size: int = 256
    bias: bool = False
    n_views: int = 5
    n_kernels: int = 3
    quartet_gate_init: float = -5.0
    quartet_scale: float = 1.0


def _count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _component(name: str) -> Optional[str]:
    """The component a parameter name counts under: the reference's
    substring rules. The gate convs (``kernels.conv``, ``fuse.*``) match
    none of them and count under no component, as in the reference."""
    if "wte" in name or "wpe" in name:
        return "embeddings"
    if "attn" in name:
        return "attention"
    if "mlp" in name or "fc" in name or "proj" in name:
        if "views" in name or "kernels" in name or "fuse" in name:
            return "mop_components"
        return "mlp"
    if "ln" in name:
        return "layer_norm"
    return None


class GPTComparisonFramework:
    """Builds, counts and smoke-tests the three GPT variants of one
    ``ComparisonConfig``."""

    def __init__(self, config: ComparisonConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        self.vocab_size: Optional[int] = None
        self.models: Dict[str, nn.Module] = {}
        self.param_counts: Dict[str, int] = {}
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}

    def _configs(self):
        c = self.config
        size = dict(n_layer=c.n_layer, n_head=c.n_head, n_embd=c.n_embd, dropout=c.dropout,
                    block_size=c.block_size, bias=c.bias)
        base = TransformerConfig(**size, use_quartet=False)
        quartet = TransformerConfig(**size, use_quartet=True,
                                    quartet_gate_init=c.quartet_gate_init,
                                    quartet_scale=c.quartet_scale)
        return base, quartet

    def _build(self, device, generator=None) -> Dict[str, nn.Module]:
        base, quartet = self._configs()
        c, v, kw = self.config, self.vocab_size, dict(device=device, generator=generator)
        return {
            "baseline": create_gpt_baseline(v, base, **kw),
            "quartet": create_gpt_quartet(v, quartet, **kw),
            "mop": create_gpt_mop(v, base, n_views=c.n_views, n_kernels=c.n_kernels, **kw),
        }

    def build_models(self, vocab_size: int) -> Dict[str, nn.Module]:
        """The three models on the ``meta`` device, and their parameter counts."""
        self.vocab_size = vocab_size
        with torch.device("meta"):
            self.models = self._build("meta")
        self.param_counts = {name: _count(m) for name, m in self.models.items()}
        return self.models

    def init_params(self, seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
        """Materialise every model on the framework's device, initialised
        from ``seed``; returns each model's parameters by name."""
        self.models = self._build(self.device, torch.Generator().manual_seed(seed))
        self.params = {name: dict(m.named_parameters()) for name, m in self.models.items()}
        return self.params

    def get_param_summary(self) -> Dict[str, Dict]:
        return {name: {"total_params": count, "total_millions": count / 1e6,
                       "components": self._count_params_by_component(name)}
                for name, count in self.param_counts.items()}

    def _count_params_by_component(self, name: str) -> Dict[str, int]:
        components = dict.fromkeys(("embeddings", "attention", "mlp", "layer_norm", "lm_head",
                                    "mop_components"), 0)
        for pname, p in self.models[name].named_parameters():
            comp = _component(pname)
            if comp is not None:
                components[comp] += p.numel()
        return components

    def parameter_matching_analysis(self) -> Dict:
        """'Matched' means within 1% of the baseline's count."""
        baseline_params = self.param_counts["baseline"]
        analysis = {"baseline_params": baseline_params, "comparisons": {}}
        for name, params in self.param_counts.items():
            if name == "baseline":
                continue
            diff = params - baseline_params
            diff_pct = diff / baseline_params * 100
            analysis["comparisons"][name] = {"params": params, "difference": diff,
                                             "difference_pct": diff_pct,
                                             "is_matched": abs(diff_pct) < 1.0}
        return analysis

    def get_model_info(self) -> Dict[str, Dict]:
        info = {}
        for name, m in self.models.items():
            cfg = m.config
            info[name] = {
                "class": type(m).__name__,
                "config": {"n_layer": cfg.n_layer, "n_head": cfg.n_head, "n_embd": cfg.n_embd,
                           "block_size": cfg.block_size, "use_quartet": cfg.use_quartet},
                "has_mop": hasattr(m, "get_gate_maps"),
                "param_count": self.param_counts[name],
            }
        return info

    def test_forward_pass(self, batch_size: int = 2, seq_len: int = 64,
                          vocab_size: int = 1000) -> Dict[str, Dict]:
        """An eval forward with targets of every model on random tokens (and
        the gate maps of the MoP model); a model that fails records its
        error instead. Materialises the models from seed 0 if
        ``init_params`` has not run."""
        if not self.params:
            self.init_params(0)
        g = torch.Generator().manual_seed(0)
        x = torch.randint(0, vocab_size, (batch_size, seq_len), generator=g).to(self.device)
        y = torch.randint(0, vocab_size, (batch_size, seq_len), generator=g).to(self.device)
        results = {}
        for name, m in self.models.items():
            try:  # a boundary: each model's failure is recorded, the others still run
                with torch.no_grad():
                    logits, loss = m.eval()(x, targets=y)
                    results[name] = {"logits": logits, "loss": loss,
                                     "logits_shape": tuple(logits.shape),
                                     "loss_value": float(loss)}
                    if hasattr(m, "get_gate_maps"):
                        gates, views, kernels = m.get_gate_maps(x)
                        results[name]["mop_maps"] = {"gates_shape": tuple(gates.shape),
                                                     "views_shape": tuple(views.shape),
                                                     "kernels_shape": tuple(kernels.shape)}
            except Exception as e:  # noqa: BLE001 - reported per model, as the reference
                results[name] = {"error": f"{type(e).__name__}: {e}"}
        return results

    def print_comparison_summary(self) -> None:
        print("=" * 80)
        print("GPT MODEL COMPARISON: Baseline vs Quartet vs MoP")
        print("=" * 80)
        print("\nPARAMETER COUNTS:")
        for name, count in self.param_counts.items():
            print(f"{name:>10}: {count:>12,} ({count / 1e6:>6.2f}M)")
        analysis = self.parameter_matching_analysis()
        print(f"\nPARAMETER MATCHING (Baseline: {analysis['baseline_params']:,}):")
        for name, comp in analysis["comparisons"].items():
            status = "MATCHED" if comp["is_matched"] else "MISMATCHED"
            print(f"{name:>10}: {comp['difference']:+,} ({comp['difference_pct']:+.2f}%) "
                  f"{status}")
        print("=" * 80)


def create_comparison_framework(config: ComparisonConfig,
                                device: Optional[Union[str, torch.device]] = None
                                ) -> GPTComparisonFramework:
    return GPTComparisonFramework(config, device=device)
