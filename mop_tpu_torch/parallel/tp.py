"""Tensor parallelism over the mesh's ``model`` axis — the port of
``mop_tpu/parallel/tp.py``.

Which weights are split is the JAX package's rule, kept: ``TP_RULES_DEFAULT``
matches the JAX path of each parameter (``paths.jax_path``) — column-parallel
(split the output features) for ``qkv``, ``q_proj`` ... ``fc1``, row-parallel
(split the input features) for ``proj``, ``o_proj``, ``fc2`` — and demotes to
replicated a leaf that is not 2-D or whose split dim does not divide by the
axis. Everything else is replicated.

GSPMD computes any such layout; here the compute is written out, the
Megatron way, with each process holding its slice of a split weight as a
plain parameter of the module (``full_shape``, ``shard_dim``):

- a column / row pair in one module (the ViT ``MSA`` and ``MLP``, the GPT
  ``CausalSelfAttention`` and ``MLP``) runs on this process's share of the
  features between them: the module's input goes through ``comm.copy_to``
  and its output, the row product's partial sums, through
  ``comm.reduce_from``. The attention runs on ``heads / tp`` heads, through
  K1 or K5 on plain local tensors (the kernels are custom ops with no
  DTensor rule, which is why this is not ``parallelize_module``). The packed
  ``qkv`` is split by head: each process holds the q, k and v rows of its
  own heads (a contiguous split would give the first all of q).
- a split weight with no partner (the MoP gate's ``ViewsLinear.proj``, row
  split on D, whose input is whole on every process) takes its slice of the
  input (its gradient all-reduced back, ``comm.copy_to``) and all-reduces its
  output; a lone column one all-gathers its output. Without sequence
  parallelism, then, a ViT or GPT step's only collective is the all-reduce.
- a replicated parameter used inside the split region (the Quartet
  ``mixture`` and ``quartet_scale``, a split layer's bias) gets part of its
  gradient on each process; the step sums those over the axis.

``sequence_parallel`` (GPT family): between the attention and MLP blocks the
token axis is split over the model axis, the Megatron-SP layout JAX reaches
by sharding the input tokens. Each block all-gathers the tokens into its
attention and MLP and reduce-scatters their outputs; the LayerNorms and
residuals run on T / tp tokens (their parameters' gradients summed by the
step); the MoP gate and the head run on the whole sequence. The model keeps
its own forward: a pre-hook on the first block splits the embedded tokens and
one on ``ln_f`` gathers them.

Dropout masks are drawn for the whole tensor one device would hold and each
process keeps its block (``layers.RandomDrop.shards``), so the step equals the
replicated one (``tests/test_torch_parallel_tp.py``).
"""

from __future__ import annotations

import functools
import re
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models import components as vit
from ..models import gpt_mop
from ..models import quartet_attn_patch as gpt
from ..models.generate import DecodeSplit
from ..models.layers import set_generator
from ..ops import preprocess as pp
from . import comm
from .mesh import MODEL_AXIS, Mesh, Sharding
from .paths import jax_axes, jax_path
from .train_step import _DataParallel, _call, _step_device

Tensor = torch.Tensor

# (path regex, spec of the JAX kernel (in, out)) — first match wins.
TP_RULES_DEFAULT: List[Tuple[str, Tuple]] = [
    # column-parallel: split the output features
    (r"(^|/)(qkv|q_proj|k_proj|v_proj|q2_proj|k2_proj|fc|fc1|mlp_fc1)/kernel$",
     (None, MODEL_AXIS)),
    # row-parallel: split the input features
    (r"(^|/)(proj|o_proj|fc2|mlp_fc2)/kernel$", (MODEL_AXIS, None)),
]

# The modules whose column / row pair runs split: {type: (columns, rows)}.
_PAIRS = {
    vit.MSA: (("qkv",), ("proj",)),
    vit.MLP: (("fc1",), ("fc2",)),
    gpt.CausalSelfAttention: (("q_proj", "k_proj", "v_proj", "q2_proj", "k2_proj"),
                              ("o_proj",)),
    gpt.MLP: (("fc",), ("proj",)),
}


def _spec_for(path: str, rules) -> Tuple:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def tp_param_shardings(model: nn.Module, mesh: Mesh,
                       rules: Optional[Sequence] = None) -> Dict[str, Sharding]:
    """``{name: Sharding}`` of every parameter under the rules; a spec's
    entries are the torch tensor's dims (column-parallel: dim 0 of the
    Linear's (out, in) weight)."""
    rules = TP_RULES_DEFAULT if rules is None else rules
    m = mesh.shape[MODEL_AXIS]
    out = {}
    for name, p in model.named_parameters():
        shape = getattr(p, "full_shape", tuple(p.shape))
        spec = _spec_for(jax_path(model, name), rules)
        if spec:
            axes = jax_axes(model, name, len(shape))
            jax_axis = 0 if spec[0] == MODEL_AXIS else len(shape) - 1
            # Matmul kernels only (a conv kernel named proj is 4-D), and a
            # dim that does not divide falls back to replicated.
            if len(shape) != 2 or shape[axes[jax_axis]] % m:
                spec = ()
            else:
                torch_spec = [None] * len(shape)
                torch_spec[axes[jax_axis]] = MODEL_AXIS
                spec = tuple(torch_spec)
        out[name] = Sharding(mesh, spec)
    return out


class _TPState:
    """What ``tp_shard_params`` set up on a model."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.group = mesh.group(MODEL_AXIS)
        self.size = mesh.shape[MODEL_AXIS]
        self.index = mesh.axis_index(MODEL_AXIS)
        self.partial: List[nn.Parameter] = []  # grads summed over the axis
        self.sp_partial: List[nn.Parameter] = []  # ... under sequence parallel too
        self.sequence_parallel = False
        self.sp_hooks: list = []  # the token split's and gather's pre-hooks
        self.paired: List[nn.Module] = []
        self.modes: Dict[nn.Linear, str] = {}  # each split linear's, ``DecodeSplit.modes``


def _take(t: Tensor, dim: int, st: _TPState, by_head: bool = False) -> Tensor:
    if by_head:  # (3 D, D_in): q, k and v rows of this process's heads
        three = t.reshape(3, st.size, -1, t.shape[-1])[:, st.index]
        return three.reshape(-1, t.shape[-1])
    n = t.shape[dim] // st.size
    return t.narrow(dim, st.index * n, n)


def _shard_weight(lin: nn.Linear, dim: int, st: _TPState, by_head: bool = False) -> None:
    with torch.no_grad():
        w = nn.Parameter(_take(lin.weight, dim, st, by_head).clone())
    w.full_shape, w.shard_dim, w.shard_axis = tuple(lin.weight.shape), dim, MODEL_AXIS
    w.by_head = by_head
    spec = [None] * w.dim()
    spec[dim] = MODEL_AXIS
    w.sharding = Sharding(st.mesh, tuple(spec))
    lin._parameters["weight"] = w


def _column(lin: nn.Linear, st: _TPState, paired: bool, by_head: bool = False) -> None:
    """Split the output features. Paired: the output stays this process's
    share; alone: its input is copied in and its output all-gathered."""
    full_out = lin.weight.shape[0]
    _shard_weight(lin, 0, st, by_head)
    st.modes[lin] = "column" if paired else "column_alone"
    if lin.bias is not None:
        st.partial.append(lin.bias)
    rows = None
    if lin.bias is not None:
        idx = torch.arange(full_out, device=lin.weight.device)
        rows = _take(idx[:, None], 0, st, by_head)[:, 0]

    def forward(self, x):
        if not paired:
            x = comm.copy_to(x, st.group)
        y = F.linear(x, self.weight, self.bias[rows] if self.bias is not None else None)
        return y if paired else comm.gather_dim(y, -1, st.group, grad="slice")

    lin.forward = types.MethodType(forward, lin)


def _row(lin: nn.Linear, st: _TPState, paired: bool) -> None:
    """Split the input features. Paired: the input is this process's share
    and the output partial sums (the module reduces them); alone: the whole
    input is sliced here and the output all-reduced."""
    _shard_weight(lin, 1, st)
    st.modes[lin] = "row" if paired else "row_alone"
    if lin.bias is not None:
        st.partial.append(lin.bias)

    def forward(self, x):
        if not paired:  # this process's features; the input's grad summed back
            n = x.shape[-1] // st.size
            x = comm.copy_to(x, st.group).narrow(-1, st.index * n, n)
        # Each process adds 1 / tp of the bias, so the sum adds it once.
        y = F.linear(x, self.weight, self.bias / st.size if self.bias is not None else None)
        return y if paired else comm.reduce_from(y, st.group)

    lin.forward = types.MethodType(forward, lin)


def _wrap_region(mod: nn.Module, st: _TPState) -> None:
    """The module's input into, and its partial-sum output out of, the split
    region: copy / all-reduce, or under sequence parallelism all-gather /
    reduce-scatter of the tokens (dim 1)."""
    inner = mod.forward

    def forward(self, x, *args, **kwargs):
        if kwargs.get("need_weights"):
            raise ValueError("tensor-parallel attention returns no weights")
        if st.sequence_parallel:
            y = inner(comm.gather_dim(x, 1, st.group, grad="sum"), *args, **kwargs)
            return comm.reduce_scatter_dim(y, 1, st.group)
        return comm.reduce_from(inner(comm.copy_to(x, st.group), *args, **kwargs), st.group)

    mod.forward = types.MethodType(forward, mod)


def tp_shard_params(model: nn.Module, mesh: Mesh, rules: Optional[Sequence] = None
                    ) -> nn.Module:
    """Split ``model``'s weights over the mesh's model axis in place, by
    ``tp_param_shardings``, and set its modules to compute on the split (the
    module docstring). The model must already be on the mesh's device with
    the same values on every process (``mesh.replicate``). A GPT-family
    model gets its ``decode_split`` for the cached decode and the serving
    engines. Returns it."""
    if hasattr(model, "_tp"):
        raise ValueError("the model is tensor-parallel already")
    st = _TPState(mesh)
    specs = tp_param_shardings(model, mesh, rules)
    split = {n for n, s in specs.items() if s.spec}
    done = set()
    for mname, mod in model.named_modules():
        pair = next((v for k, v in _PAIRS.items() if type(mod) is k), None)
        if pair is None:
            continue
        prefix = f"{mname}." if mname else ""
        cols = [c for c in pair[0] if hasattr(mod, c)]
        rows = [r for r in pair[1] if hasattr(mod, r)]
        names = [f"{prefix}{c}.weight" for c in cols + rows]
        heads = getattr(mod, "heads", getattr(mod, "n_head", None))
        if not all(n in split for n in names) or (heads is not None and heads % st.size):
            continue
        for c in cols:
            _column(getattr(mod, c), st, True, by_head=isinstance(mod, vit.MSA))
        for r in rows:
            _row(getattr(mod, r), st, True)
        done.update(names)
        if isinstance(mod, vit.MSA):
            mod.heads //= st.size
        if isinstance(mod, gpt.CausalSelfAttention):
            mod.n_head //= st.size
            if mod.config.use_quartet:
                st.partial += [mod.mixture, mod.quartet_scale]
        if hasattr(mod, "attn_drop"):  # the scores of this process's heads
            mod.attn_drop.tp_shards = ((1, st.index, st.size),)
        _wrap_region(mod, st)
        st.paired.append(mod)
    for name in sorted(split - done):
        mod_name = name.rpartition(".")[0]
        lin = model.get_submodule(mod_name)
        if not isinstance(lin, nn.Linear):
            raise NotImplementedError(f"tensor-parallel {type(lin).__name__} ({name})")
        (_column if specs[name].spec[0] == MODEL_AXIS else _row)(lin, st, False)
    for blk in getattr(model, "blocks", ()):
        if isinstance(blk, gpt.Block):
            st.sp_partial += list(blk.ln1.parameters()) + list(blk.ln2.parameters())
    model._tp = st
    model.decode_split = decode_split(model)
    return model


def decode_split(model: nn.Module) -> Optional[DecodeSplit]:
    """The ``models.generate.DecodeSplit`` of a tensor-parallel GPT-family
    model (None for any other): this process's heads, each split linear's
    mode by its name in a block, and the sum and broadcast over the model
    axis."""
    st = getattr(model, "_tp", None)
    if st is None or not isinstance(model, gpt.TinyTransformerLM):
        return None
    modes = [{n: st.modes[m] for n, m in blk.named_modules() if m in st.modes}
             for blk in model.blocks]
    if any(m != modes[0] for m in modes) or "column_alone" in modes[0].values():
        raise NotImplementedError(f"decode of a tensor-parallel split {modes}")
    g = st.group
    src = 0 if g is None else dist.get_global_rank(g, 0)
    return DecodeSplit(st.index, st.size, model.blocks[0].attn.n_head, modes[0],
                       all_reduce=functools.partial(comm.all_reduce_, group=g),
                       broadcast=functools.partial(comm.broadcast_, group=g, src=src))


def _sequence_parallel(model: nn.Module, on: bool) -> None:
    """Switch the GPT family's token split between blocks on or off."""
    st = model._tp
    if on == st.sequence_parallel:
        return
    if on:
        if not isinstance(model, gpt.TinyTransformerLM):
            raise ValueError("sequence_parallel is for the GPT family")
        blocks = list(model.blocks)
        if not all(b.attn in st.paired and b.mlp in st.paired for b in blocks):
            raise ValueError("sequence_parallel needs every block's attention and MLP split")
        g = st.group

        def split(blk, args, kwargs):  # the tokens enter the first block split
            if kwargs.get("attention_mask") is not None:
                raise ValueError("sequence-parallel LM takes no attention_mask")
            return (comm.split_dim(args[0], 1, g),) + args[1:], kwargs

        def gather(ln, args):  # and leave the last one whole
            return (comm.gather_dim(args[0], 1, g, grad="slice"),) + args[1:]

        st.sp_hooks = [blocks[0].register_forward_pre_hook(split, with_kwargs=True),
                       model.ln_f.register_forward_pre_hook(gather)]
        for blk in blocks:
            if isinstance(blk, gpt_mop.MoPBlock):  # the gate sees the whole sequence
                def apply_mop(self, x):
                    gate = self.get_gate_maps(comm.gather_dim(x, 1, g, grad="slice"))[0]
                    return x * comm.split_dim(gate, 2, g).transpose(1, 2)

                blk.apply_mop = types.MethodType(apply_mop, blk)
    else:
        for h in st.sp_hooks:
            h.remove()
        st.sp_hooks = []
        for blk in model.blocks:
            blk.__dict__.pop("apply_mop", None)
    st.sequence_parallel = on


def tp_init_opt_state(make_optimizer: Callable, model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer over a tensor-parallel model's parameters (its slices),
    so each moment is split exactly like its weight."""
    if not hasattr(model, "_tp"):
        raise ValueError("pass the model through tp_shard_params first")
    return make_optimizer(list(model.parameters()))


def _tp_step(model, optimizer, mesh, loss_fn, compute_dtype, device):
    if not hasattr(model, "_tp"):
        raise ValueError("pass the model through tp_shard_params first")
    st = model._tp
    device = _step_device(device, mesh)
    dp = _DataParallel(mesh, model)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(*batch, generator=None):
        model.train()
        set_generator(model, generator)
        dp.draw_shards(lambda m: getattr(m, "tp_shards", ()))
        batch = [b.to(device, non_blocking=True) for b in batch]
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(lambda *a, **k: _call(model, compute_dtype, *a, **k), *batch, generator)
        loss.backward()
        partial = st.partial + (st.sp_partial if st.sequence_parallel else [])
        comm.all_reduce_flat_([p.grad for p in partial if p.grad is not None], st.group)
        dp.mean_grads(params)
        optimizer.step()
        (loss,) = dp.mean(loss.detach())
        return {"loss": loss}

    return step


def make_tp_classifier_train_step(model: nn.Module, optimizer, mesh: Mesh, mean, std,
                                  augment: bool = True,
                                  compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                                  device=None):
    """dp x tp train step: ``step(x_u8, y, generator) -> {"loss"}``, the batch
    over the data axis (each process passes its data index's rows), the
    weights over the model axis. The model through ``tp_shard_params`` and
    the optimizer from ``tp_init_opt_state`` first."""
    dp = _DataParallel(mesh, model)

    def loss_fn(forward, x_u8, y, generator):
        if augment:
            x = pp.cifar_train_augment(generator, x_u8, mean, std, shard=dp.shard)
        else:
            x = pp.cifar_eval_transform(x_u8, mean, std)
        x = x.to(compute_dtype) if compute_dtype is not None else x
        return F.cross_entropy(forward(x).float(), y.long())

    step = _tp_step(model, optimizer, mesh, loss_fn, compute_dtype, device)

    def classifier_step(x_u8: Tensor, y: Tensor, generator: Optional[torch.Generator] = None):
        if augment and generator is None:
            raise ValueError("the train augment draws from an explicit torch.Generator; "
                             "pass one on the step's device")
        return step(x_u8, y, generator=generator)

    return classifier_step


def make_tp_lm_train_step(model: nn.Module, optimizer, mesh: Mesh,
                          compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                          sequence_parallel: bool = False, device=None):
    """dp x tp train step for the GPT family: ``step(idx, targets, generator=
    None) -> {"loss"}``. ``sequence_parallel`` also splits the tokens between
    blocks (the module docstring)."""
    _sequence_parallel(model, sequence_parallel)

    def loss_fn(forward, idx, targets, generator):
        return forward(idx, targets=targets)[1].float()

    step = _tp_step(model, optimizer, mesh, loss_fn, compute_dtype, device)
    return lambda idx, targets, generator=None: step(idx, targets, generator=generator)


def full_state_dict(model: nn.Module) -> Dict[str, Tensor]:
    """Every parameter whole (a collective over the model axis for the split
    ones), the packed qkv back in its q, k, v order."""
    st = model._tp
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = getattr(p, "shard_dim", None)
            t = p.detach()
            if dim is not None and st.group is not None:
                if getattr(p, "by_head", False):
                    g = comm._gather(t.reshape(3, -1, t.shape[-1]), 1, st.group)
                    t = g.reshape(-1, t.shape[-1])
                else:
                    t = comm._gather(t, dim, st.group)
            out[name] = t.clone()
    return out
