"""The Whisper comparison framework, Baseline vs MoP, in PyTorch: the port of
``mop_tpu/models/whisper_comparison.py``.

``build_models`` builds both models on the ``meta`` device, which counts
their parameters without allocating weights; ``init_params`` materialises
them on the framework's device (the GPU unless given) from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .whisper_mop import WhisperConfig, create_whisper_baseline, create_whisper_mop


@dataclass
class WhisperComparisonConfig:
    """The reference comparison config."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_layer: int = 12
    n_head: int = 20
    n_embd: int = 1280
    dropout: float = 0.0
    bias: bool = False
    n_views: int = 5
    n_kernels: int = 3
    kernel_size: int = 5
    vocab_size: int = 51865
    use_abs_pos_emb: bool = True


def _count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class WhisperComparisonFramework:
    """Builds, counts and smoke-tests the baseline and MoP Whisper of one
    ``WhisperComparisonConfig``."""

    def __init__(self, config: WhisperComparisonConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        self.models: Dict[str, nn.Module] = {}
        self.param_counts: Dict[str, int] = {}
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}

    def _whisper_config(self) -> WhisperConfig:
        c = self.config
        return WhisperConfig(
            n_mels=c.n_mels, n_audio_ctx=c.n_audio_ctx, n_layer_enc=c.n_layer,
            n_layer_dec=c.n_layer, n_head=c.n_head, n_embd=c.n_embd,
            n_text_ctx=c.n_audio_ctx,  # the reference uses the audio context for the text's
            dropout=c.dropout, bias=c.bias, n_views=c.n_views, n_kernels=c.n_kernels,
            kernel_size=c.kernel_size, vocab_size=c.vocab_size,
            use_abs_pos_emb=c.use_abs_pos_emb)

    def _build(self, device, generator=None) -> Dict[str, nn.Module]:
        cfg, kw = self._whisper_config(), dict(device=device, generator=generator)
        return {"baseline": create_whisper_baseline(cfg, **kw),
                "mop": create_whisper_mop(cfg, **kw)}

    def build_models(self) -> Dict[str, nn.Module]:
        """Both models on the ``meta`` device, and their parameter counts."""
        with torch.device("meta"):
            self.models = self._build("meta")
        self.param_counts = {name: _count(m) for name, m in self.models.items()}
        return self.models

    def init_params(self, seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
        """Materialise both models on the framework's device, initialised
        from ``seed``; returns each model's parameters by name."""
        self.models = self._build(self.device, torch.Generator().manual_seed(seed))
        self.params = {name: dict(m.named_parameters()) for name, m in self.models.items()}
        return self.params

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

    def _materialised(self) -> Dict[str, nn.Module]:
        if not self.params:
            self.init_params(0)
        return self.models

    def test_forward_pass(self, batch_size: int = 2, t_audio: int = 16,
                          t_text: int = 16) -> Dict[str, Dict]:
        """An eval forward with targets of both models on a random mel and
        random tokens; a model that fails records its error instead.
        Materialises the models from seed 0 if ``init_params`` has not run."""
        cfg = self._whisper_config()
        models = self._materialised()
        g = torch.Generator().manual_seed(0)
        mel = torch.randn(batch_size, t_audio, cfg.n_mels, generator=g).to(self.device)
        ids = torch.randint(0, cfg.vocab_size, (batch_size, t_text), generator=g).to(self.device)
        tgt = torch.randint(0, cfg.vocab_size, (batch_size, t_text), generator=g).to(self.device)
        results = {}
        for name, m in models.items():
            try:  # a boundary: each model's failure is recorded, the other still runs
                with torch.no_grad():
                    logits, loss, gates = m.eval()(mel, ids, targets=tgt)
                results[name] = {"logits_shape": tuple(logits.shape),
                                 "loss_value": float(loss),
                                 "gates_shape": tuple(gates.shape)}
            except Exception as e:  # noqa: BLE001 - reported per model, as the reference
                results[name] = {"error": f"{type(e).__name__}: {e}"}
        return results

    def test_audio_processing(self, t_audio: int = 24) -> Dict[str, Dict]:
        """Gate maps of a synthetic spectrogram with a diagonal and a stripe."""
        cfg = self._whisper_config()
        models = self._materialised()
        mel = torch.zeros(1, t_audio, cfg.n_mels)
        idx = torch.arange(min(t_audio, cfg.n_mels))
        mel[0, idx, idx] = 1.0
        mel[0, :, min(8, cfg.n_mels - 1)] += 0.5
        mel = mel.to(self.device)
        results = {}
        for name, m in models.items():
            with torch.no_grad():
                gates = m.get_gate_maps(mel)
            results[name] = {"gates_shape": tuple(gates.shape)}
        return results

    def print_comparison_summary(self) -> None:
        print("=" * 80)
        print("WHISPER MODEL COMPARISON: Baseline vs MoP")
        print("=" * 80)
        for name, count in self.param_counts.items():
            print(f"{name:>10}: {count:>12,} ({count / 1e6:>6.2f}M)")
        analysis = self.parameter_matching_analysis()
        for name, comp in analysis["comparisons"].items():
            status = "MATCHED" if comp["is_matched"] else "MISMATCHED"
            print(f"{name:>10}: {comp['difference']:+,} ({comp['difference_pct']:+.2f}%) "
                  f"{status}")
        print("=" * 80)


def create_whisper_comparison_framework(
        config: WhisperComparisonConfig,
        device: Optional[Union[str, torch.device]] = None) -> WhisperComparisonFramework:
    return WhisperComparisonFramework(config, device=device)
