"""Shared inputs of the port's pipeline tests: the JAX tests' GPT families
(4 layers, 4 heads, 64 wide, block 16, vocab 64), JAX's init at
``PRNGKey(0)`` in the port's layout, the seeded batch, and JAX's one-device
reference step (``model.apply`` + ``optax.adamw(1e-3)``, as
``tests/test_parallel_pp.py``'s ``_ref_step``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu_torch.utils.jax_weights import load_jax_params
from tests._torch_parallel_common import jax_init

CFG = dict(n_layer=4, n_head=4, n_embd=64, dropout=0.0, block_size=16)
KW = {"base": {}, "quartet": {}, "mop": dict(n_views=3, n_kernels=2)}
JAX_FACTORIES = {"base": J.create_gpt_baseline, "quartet": J.create_gpt_quartet,
                 "mop": J.create_gpt_mop}
PORT_FACTORIES = {"base": P.create_gpt_baseline, "quartet": P.create_gpt_quartet,
                  "mop": P.create_gpt_mop}
FAMILIES = tuple(KW)


def batch(b=16):
    idx = np.random.RandomState(0).randint(0, 64, (b, 16)).astype(np.int64)
    return idx, np.roll(idx, -1, axis=-1)


def port_model(fam, params=None, dropout=0.0):
    cfg = P.TransformerConfig(**dict(CFG, dropout=dropout))
    model = PORT_FACTORIES[fam](64, cfg, device="cpu", **KW[fam])
    return load_jax_params(model, params) if params is not None else model


def jax_setup():
    """{family: (JAX model, JAX params, port state dict)}."""
    idx, _ = batch()
    out = {}
    for fam in FAMILIES:
        model = JAX_FACTORIES[fam](64, J.TransformerConfig(**CFG), **KW[fam])
        params = jax_init(model, 0, jnp.asarray(idx, jnp.int32))
        out[fam] = (model, params, port_model(fam, params).state_dict())
    return out


def jax_ref_step(model, params, idx, tgt):
    """JAX's one-device step: (loss, the params after it in the port's layout)."""
    tx = optax.adamw(1e-3)

    def lf(p):
        return model.apply(p, jnp.asarray(idx, jnp.int32),
                           targets=jnp.asarray(tgt, jnp.int32), train=False)[1]

    loss, g = jax.jit(jax.value_and_grad(lf))(params)
    u, _ = tx.update(g, tx.init(params), params)
    return float(loss), jax.device_get(optax.apply_updates(params, u))


def port_ref_step(fam, sd, idx, tgt, dropout=0.0):
    """The port's one-device step, fp32: (loss, state dict after it)."""
    model = port_model(fam, dropout=dropout)
    model.load_state_dict(sd)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = P.make_lm_train_step(model, opt, compute_dtype=None, device="cpu")
    loss = step(torch.as_tensor(idx), torch.as_tensor(tgt))["loss"].item()
    return loss, {k: v.detach().clone() for k, v in model.state_dict().items()}
