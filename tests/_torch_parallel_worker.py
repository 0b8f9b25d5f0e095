"""One rank of the port's multi-process tests: run as

    python -m mop_tpu_torch.cli.launch_multihost --nproc 4 -- \\
        python tests/_torch_parallel_worker.py SCENARIO DIR

Each rank joins the gloo group (``make_mesh(device="cpu")`` reads the
launcher's variables), runs every case of the scenario on the inputs the
test wrote to ``DIR/inputs.pt`` and writes what it saw to ``DIR/rank{r}.pt``.
The tests hold those against the port's one-device steps and the JAX
package, which they run themselves.
"""

from __future__ import annotations

import os
import sys
import traceback
from unittest import mock

import torch

import mop_tpu_torch as P
from mop_tpu_torch.experiments import common as C
from mop_tpu_torch.ops import moe as ops_moe
from mop_tpu_torch.ops import ring_attention as ring
from mop_tpu_torch.ops.preprocess import CIFAR100_MEAN, CIFAR100_STD
from mop_tpu_torch.parallel import fsdp, multiseed, tp
from mop_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from mop_tpu_torch.utils.collectives import collective_summary, record_collectives
from mop_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)
MEAN, STD = CIFAR100_MEAN, CIFAR100_STD


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _vit(inp, key="vit"):
    kw = dict(inp[key + "_kw"])
    model = P.ViT_MoP(**kw, device="cpu")
    model.load_state_dict(inp[key + "_sd"])
    return model


def _gpt(inp, key="gpt", dropout=None):
    cfg = dict(inp[key + "_cfg"])
    if dropout is not None:
        cfg["dropout"] = dropout
    model = P.create_gpt_mop(inp[key + "_vocab"], P.TransformerConfig(**cfg),
                             device="cpu", **inp[key + "_kw"])
    model.load_state_dict(inp[key + "_sd"])
    return model


def _train(step, mesh, xs, ys, gen_seed, steps=3):
    g = torch.Generator().manual_seed(gen_seed)
    losses = []
    for i in range(steps):
        x, y = shard_batch((xs[i], ys[i]), mesh)
        losses.append(step(x, y, generator=g)["loss"].item())
    return losses


# ------------------------------------------------------------------ dp --

DP_CASES = {  # name -> (model kwargs override, step kwargs)
    "jax": ({}, dict(augment=False)),
    "augment_droppath": (dict(drop_path=0.1), dict(augment=True)),
    "accum_clip_smooth": ({}, dict(augment=True, accum_steps=2, grad_clip=0.5,
                                   label_smoothing=0.1)),
}


def _eval_counts(inp, mesh):
    """The eval step's counts over a padded tail, summed over the data axis."""
    model = replicate(_vit(inp), mesh)
    ev = P.make_classifier_eval_step(model, MEAN, STD, mesh=mesh)
    c, t = ev(*shard_batch((inp["xs"][0], inp["ys"][0], inp["mask"]), mesh))
    return float(c), float(t)


def scenario_dp(inp, rank):
    res = {}
    with mock.patch.object(torch.cuda, "is_available", return_value=True):
        res["resolve_device"] = str(resolve_device())
        res["resolve_bare_cuda"] = str(resolve_device("cuda"))
    res["local_rank"] = int(os.environ["LOCAL_RANK"])
    try:
        make_mesh(n_devices=8, device="cpu")
        res["shortfall"] = None
    except ValueError as e:
        res["shortfall"] = str(e)
    # The harness's files: only the main process writes them.
    C.save_csv(os.path.join(sys.argv[2], f"written_by_{rank}.csv"), ["rank"], [[rank]])
    torch.distributed.barrier()
    res["written"] = sorted(f for f in os.listdir(sys.argv[2]) if f.startswith("written_by"))
    xs, ys = inp["xs"], inp["ys"]
    for dp in (2, 4):
        mesh = make_mesh(model_parallel=4 // dp, device="cpu")
        res[("mesh", dp)] = (dict(mesh.shape), dict(mesh.coords))
        for name, (mkw, skw) in DP_CASES.items():
            model = _vit(inp)
            if mkw:
                model = P.ViT_MoP(**{**inp["vit_kw"], **mkw}, device="cpu")
                model.load_state_dict(inp["vit_sd"])
            replicate(model, mesh)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
            step = P.make_classifier_train_step(model, opt, MEAN, STD, compute_dtype=None,
                                                mesh=mesh, **skw)
            res[("cls", name, dp)] = (_train(step, mesh, xs, ys, 7), _params(model))
        res[("eval", dp)] = _eval_counts(inp, mesh)
        for drop in (0.0, 0.1) if dp == 4 else (0.0,):  # the LM step, dropout on and off
            lm = replicate(_gpt(inp, dropout=drop), mesh)
            opt = torch.optim.AdamW(lm.parameters(), lr=1e-3)
            step = P.make_lm_train_step(lm, opt, compute_dtype=None, mesh=mesh)
            res[("lm", drop, dp)] = (_train(step, mesh, inp["idx"], inp["tgt"], 11),
                                     _params(lm))
    # At dp 4 only (mesh is the (4, 1) one): the scanned step, K = 3 steps in
    # one call; the ImageNet step, its augment suite and Mixup / CutMix
    # across processes; the collectives of one data-parallel step.
    model = replicate(_vit(inp), mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = P.make_scanned_classifier_train_step(model, opt, MEAN, STD, 3, augment=True,
                                                compute_dtype=None, mesh=mesh)
    xk, yk = shard_batch((xs.transpose(0, 1), ys.transpose(0, 1)), mesh)
    m = step(xk.transpose(0, 1), yk.transpose(0, 1), torch.Generator().manual_seed(7))
    res["scanned"] = (m["loss"].tolist(), _params(model))
    model = replicate(P.ViT_Baseline(**inp["inet_kw"], device="cpu"), mesh)
    model.load_state_dict(inp["inet_sd"])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_imagenet_train_step(model, opt, MEAN, STD, 10, use_randaug=True,
                                      compute_dtype=None, mesh=mesh)
    res["imagenet"] = (_train(step, mesh, inp["inet_x"], inp["inet_y"], 13, steps=4),
                       _params(model))
    model = replicate(_vit(inp), mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, mesh=mesh)
    x, y = shard_batch((xs[0], ys[0]), mesh)
    with record_collectives() as rec:
        step(x, y)
    res["dp_collectives"] = collective_summary(rec)
    res["n_params"] = sum(p.numel() for p in model.parameters())
    return res


# ---------------------------------------------------------------- fsdp --

def scenario_fsdp(inp, rank):
    res = {}
    mesh = make_mesh(device="cpu")
    xs, ys = inp["xs"], inp["ys"]
    ms = inp["min_size"]
    for shard in (True, False):
        model = replicate(_vit(inp), mesh)

        def make_opt(ps):
            return torch.optim.AdamW(ps, lr=1e-3)

        if shard:
            fsdp.fsdp_shard_params(model, mesh, min_size=ms)
            opt = fsdp.fsdp_init_opt_state(make_opt, model, mesh, min_size=ms)
        else:
            opt = fsdp.zero1_init_opt_state(make_opt, model, mesh, min_size=ms)
        step = fsdp.make_fsdp_classifier_train_step(
            model, opt, mesh, MEAN, STD, augment=False, compute_dtype=None,
            shard_params=shard, grad_clip=inp["clip"])
        losses = _train(step, mesh, xs, ys, 3)
        params = fsdp.full_state_dict(model)
        if shard:
            res["local_shapes"] = {n: (tuple(p.shape), getattr(p, "full_shape", None),
                                       getattr(p, "shard_dim", None))
                                   for n, p in model.named_parameters()}
            res["moment_shapes"] = {
                i: tuple(s["exp_avg"].shape) for i, s in enumerate(opt.state.values())}
            res["specs"] = {n: s.spec for n, s in
                            fsdp.fsdp_param_shardings(model, mesh, min_size=ms).items()}
        else:
            res["zero1_moments"] = [tuple(opt.optimizer.state[own]["exp_avg"].shape)
                                    for _, _, own in opt.entries]
            res["zero1_full"] = [tuple(p.shape) for p, _, _ in opt.entries]
        x, y = shard_batch((xs[0], ys[0]), mesh)
        with record_collectives() as rec:
            step(x, y, generator=torch.Generator())
        res[("cls", shard)] = (losses, params, collective_summary(rec))
    # The replicated data-parallel reference, in the same group.
    model = replicate(_vit(inp), mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, grad_clip=inp["clip"], mesh=mesh)
    res["cls_dp"] = (_train(step, mesh, xs, ys, 3), _params(model))
    for shard in (True, False):
        lm = replicate(_gpt(inp), mesh)

        def make_opt(ps):
            return torch.optim.AdamW(ps, lr=1e-3)

        if shard:
            fsdp.fsdp_shard_params(lm, mesh, min_size=ms)
            opt = fsdp.fsdp_init_opt_state(make_opt, lm, mesh, min_size=ms)
        else:
            opt = fsdp.zero1_init_opt_state(make_opt, lm, mesh, min_size=ms)
        step = fsdp.make_fsdp_lm_train_step(lm, opt, mesh, compute_dtype=None,
                                            shard_params=shard)
        res[("lm", shard)] = (_train(step, mesh, inp["idx"], inp["tgt"], 3),
                              fsdp.full_state_dict(lm))
    lm = replicate(_gpt(inp), mesh)
    opt = torch.optim.AdamW(lm.parameters(), lr=1e-3)
    step = P.make_lm_train_step(lm, opt, compute_dtype=None, mesh=mesh)
    res["lm_dp"] = (_train(step, mesh, inp["idx"], inp["tgt"], 3), _params(lm))
    return res


# ------------------------------------------------------------------ tp --

def scenario_tp(inp, rank):
    res = {}
    xs, ys = inp["xs"], inp["ys"]
    for t in (2, 4):
        mesh = make_mesh(model_parallel=t, device="cpu")
        model = replicate(_vit(inp), mesh)
        full_qkv = model.enc.blocks[0].attn.qkv.weight.detach().clone()
        tp.tp_shard_params(model, mesh)
        if t == 2:
            res["qkv_local"] = (full_qkv, model.enc.blocks[0].attn.qkv.weight.detach().clone(),
                                mesh.axis_index("model"), model.enc.blocks[0].attn.heads)
            # ViewsLinear.proj alone: row-split on D, its input whole.
            res["views"] = model.views(inp["tok"], (4, 4)).detach()
        opt = tp.tp_init_opt_state(lambda ps: torch.optim.AdamW(ps, lr=1e-3), model)
        step = tp.make_tp_classifier_train_step(model, opt, mesh, MEAN, STD, augment=False,
                                                compute_dtype=None)
        res[("cls", t)] = (_train(step, mesh, xs, ys, 5), tp.full_state_dict(model))
    mesh = make_mesh(device="cpu")
    model = replicate(_vit(inp), mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, mesh=mesh)
    res["cls_dp"] = (_train(step, mesh, xs, ys, 5), _params(model))
    mesh = make_mesh(model_parallel=2, device="cpu")
    for drop in (0.0, 0.1):
        for sp in (False, True) if drop == 0.0 else (True,):
            lm = replicate(_gpt(inp, dropout=drop), mesh)
            tp.tp_shard_params(lm, mesh)
            opt = tp.tp_init_opt_state(lambda ps: torch.optim.AdamW(ps, lr=1e-3), lm)
            step = tp.make_tp_lm_train_step(lm, opt, mesh, compute_dtype=None,
                                            sequence_parallel=sp)
            res[("lm", drop, sp)] = (_train(step, mesh, inp["idx"], inp["tgt"], 9),
                                     tp.full_state_dict(lm))
            if drop == 0.0:
                with record_collectives() as rec:
                    step(*shard_batch((inp["idx"][0], inp["tgt"][0]), mesh))
                res[("lm_collectives", sp)] = collective_summary(rec)
            if sp and drop == 0.0:
                # Sequence parallelism is two pre-hooks on the model's own
                # forward: switched off, the same weights give the same logits.
                idx = shard_batch(inp["idx"][0], mesh)
                lm.eval()
                with torch.no_grad():
                    on = lm(idx)[0]
                    try:
                        lm(idx, attention_mask=torch.zeros(idx.shape[1], idx.shape[1]))
                        res["sp_mask_raise"] = None
                    except ValueError as e:
                        res["sp_mask_raise"] = str(e)
                    tp.make_tp_lm_train_step(lm, opt, mesh, compute_dtype=None,
                                             sequence_parallel=False)
                    off = lm(idx)[0]
                res["sp_off"] = (on, off, "forward" in vars(lm),
                                 len(lm.blocks[0]._forward_pre_hooks),
                                 len(lm.ln_f._forward_pre_hooks))
        lm = replicate(_gpt(inp, dropout=drop), mesh)
        opt = torch.optim.AdamW(lm.parameters(), lr=1e-3)
        step = P.make_lm_train_step(lm, opt, compute_dtype=None, mesh=mesh)
        res[("lm_dp", drop)] = (_train(step, mesh, inp["idx"], inp["tgt"], 9), _params(lm))
    return res


# ----------------------------------------------------------- ring, moe --

def scenario_ring_moe(inp, rank):
    res = {}
    q, k, v = inp["q"], inp["k"], inp["v"]
    for s in (2, 4):
        mesh = make_mesh(model_parallel=s, device="cpu")
        for causal in (False, True):
            ql, kl, vl = (ring.shard_sequence(t, mesh).clone().requires_grad_() for t in (q, k, v))
            out = ring.ring_attention(ql, kl, vl, mesh, causal=causal)
            (out * inp["w"]).sum().backward()
            res[("ring", s, causal)] = (ring.gather_sequence(out.detach(), mesh),
                                        *(ring.gather_sequence(t.grad, mesh) for t in (ql, kl, vl)))
        if s == 4:
            ql, kl, vl = (ring.shard_sequence(t, mesh) for t in (q, k, v))
            with record_collectives() as rec:
                ring.ring_attention(ql, kl, vl, mesh, causal=True)
            res["ring_fwd_collectives"] = collective_summary(rec)
            ql, kl, vl = (t.clone().requires_grad_() for t in (ql, kl, vl))
            out = ring.ring_attention(ql, kl, vl, mesh, causal=True)
            with record_collectives() as rec:
                out.sum().backward()
            res["ring_bwd_collectives"] = collective_summary(rec)
            res["ring_block_bytes"] = kl.numel() * kl.element_size()
            try:
                ring.shard_sequence(q[:, :, :-1], mesh)
                res["ring_raise"] = None
            except ValueError as e:
                res["ring_raise"] = str(e)
        for cf in inp["capacity_factors"]:
            mi, n = mesh.axis_index("model"), mesh.shape["model"]
            x = inp["moe_x"]
            t_loc, e_loc = x.shape[0] // n, inp["moe_w1"].shape[0] // n
            xl = x[mi * t_loc:(mi + 1) * t_loc].clone().requires_grad_()
            w1 = inp["moe_w1"][mi * e_loc:(mi + 1) * e_loc].clone().requires_grad_()
            w2 = inp["moe_w2"][mi * e_loc:(mi + 1) * e_loc].clone().requires_grad_()
            with record_collectives() as rec:
                y = ops_moe.expert_parallel_top1_mlp(xl, inp["moe_gw"], inp["moe_gb"], w1, w2,
                                                     P.models.layers.gelu_tanh, mesh,
                                                     capacity_factor=cf)
            (y * inp["moe_w"][mi * t_loc:(mi + 1) * t_loc]).sum().backward()
            res[("moe", s, cf)] = (y.detach(), xl.grad, w1.grad, w2.grad, collective_summary(rec))
    return res


# ----------------------------------------------------------- multiseed --

def scenario_multiseed(inp, rank):
    res = {}
    mesh = make_mesh(device="cpu")
    for seeds in inp["seed_lists"]:
        s = len(seeds)

        def make_model(seed):
            return P.ViT_MoP(**inp["vit_kw"], device="cpu",
                             generator=torch.Generator().manual_seed(seed))

        stack = multiseed.multiseed_init(make_model, seeds, mesh)
        for _, m in stack:
            m.to(mesh.device)
        opts = multiseed.multiseed_opt_init(lambda ps: torch.optim.AdamW(ps, lr=1e-3), stack)
        step = multiseed.make_multiseed_scanned_train_step(
            stack, opts, mesh, MEAN, STD, n_seeds=s, unroll_steps=3, augment=True,
            compute_dtype=None)
        gens = [torch.Generator().manual_seed(100 + sd) for sd in seeds]
        with record_collectives() as rec:
            m = step(inp[f"xk{s}"], inp[f"yk{s}"], gens)
        res[("ms", s)] = (m["loss"], [multiseed.unstack_seed(stack, i) for i in range(s)],
                          [i for i, _ in stack], collective_summary(rec),
                          tuple(x.spec for x in multiseed.seed_shardings(mesh, s)))
    return res


SCENARIOS = {"dp": scenario_dp, "fsdp": scenario_fsdp, "tp": scenario_tp,
             "ring_moe": scenario_ring_moe, "multiseed": scenario_multiseed}


def main():
    name, out = sys.argv[1], sys.argv[2]
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    make_mesh(device="cpu")  # joins the group
    rank = torch.distributed.get_rank()
    try:
        res = SCENARIOS[name](inp, rank)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
