#!/usr/bin/env python3
"""BSRNN_Multi's first train-step gradient in both packages, in f32 and
in f64, from the JAX package's initial weights, on the CPU: whether the
elements where the two packages' f32 gradients take opposite signs differ
in the mathematics or only in f32 rounding.

    JAX_PLATFORMS=cpu python3 tools/multi_first_gradient_f64.py
        [--seed 0] [--threads 4]

The model, batch, loss table and schedule are those of
tests/test_torch_bsrnn_multi.py::test_two_train_steps_match_jax; the
weights are flax's `model.init` at `seed` (utils/jax_init.init_like_jax),
the BatchNorm statistics moved off (0, 1) as that test moves them. Each
dtype runs in a child process: the f64 one enables jax's x64 mode and
makes both packages' hard-coded f32 (`jnp.float32`, `torch.float32`,
`Tensor.float`, the mel bank) f64, so every sum, product and cast of both
runs in f64. The JAX step is the package's own `make_train_step` with an
optimizer that hands back the gradient; the port's gradient is what its
`make_train_step` hands its optimizer. Prints one JSON line: the packages
against each other and each f32 gradient against its f64 one (rel. L2,
whole and the encoder), the firm elements (|g| above 1e-2 of the leaf's
largest in JAX's f32) whose f32 signs differ, and at those the f64 sign's
agreement with each package's f32 sign. It imports both packages, so it
runs where JAX is installed, not on the card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_gradients(dtype, seed, threads, init, out):
    """One dtype's first gradients of both packages -> `out` (.npz of
    "jax/<name>" and "port/<name>" in f64, and the two losses); the f32
    run writes the initial weights to `init`, the f64 run reads them."""
    import numpy as np

    x64 = dtype == "f64"
    import jax

    if x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import optax
    import torch

    torch.set_num_threads(threads)
    if x64:
        jnp.float32 = jnp.float64
        torch.float32 = torch.float64
        torch.Tensor.float = lambda self, *a, **k: self.double()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import test_torch_bsrnn_multi as multi
    from wesep_tpu_torch.models.bsrnn_multi_optim import BSRNN_Multi
    from wesep_tpu_torch.ops import fbank
    from wesep_tpu_torch.train import trainer
    from wesep_tpu_torch.train.losses import parse_loss
    from wesep_tpu_torch.train.schedulers import exponential_decrease
    from wesep_tpu_torch.utils.jax_init import init_like_jax

    real = np.float64 if x64 else np.float32
    if x64:
        fbank._bank = lambda bank, like: torch.from_numpy(
            np.array(bank, np.float64)).to(like.device)
        params, stats = np.load(init, allow_pickle=True)
    else:
        model = init_like_jax(BSRNN_Multi(**multi.ARGS), seed)
        rng = np.random.default_rng(7)
        params = multi._nested({n: p.detach().numpy()
                                for n, p in model.named_parameters()})
        stats = multi._nested({
            n: b.numpy() + 0.1 * np.abs(rng.standard_normal(b.shape))
            .astype(np.float32) for n, b in model.named_buffers()
            if n.endswith((".mean", ".var"))})
        np.save(init, np.array([params, stats], dtype=object),
                allow_pickle=True)
    batch = {k: np.asarray(v, real) for k, v in multi._batch(2).items()}

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, real)), tree)

    # an optimizer whose update is the gradient: new params - params
    hand_back = optax.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (g, s))
    start = multi.jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=cast(params),
        batch_stats=cast(stats), opt_state=hand_back.init(cast(params)))
    step = jax.jit(multi.jax_trainer.make_train_step(
        multi.JaxMulti(**multi.ARGS), hand_back,
        multi.jax_parse_loss("SISDR"), **multi.TABLE))
    new, metrics = step(start, {k: jnp.asarray(v) for k, v in batch.items()})
    before, after = multi._flat(start.params), multi._flat(new.params)
    grads = {f"jax/{k}": np.asarray(v, np.float64) - np.asarray(before[k],
                                                                np.float64)
             for k, v in after.items()}

    model = multi._port(params, stats)
    if x64:
        model = model.double()
    opt = trainer.make_optimizer(model, exponential_decrease(**multi.SCHED),
                                 weight_decay=1e-4, clip_grad=5.0)
    update = opt.update

    def keep(g):
        grads.update({f"port/{k}": v.detach().double().numpy()
                      for k, v in g.items()})
        return update(g)

    opt.update = keep
    _, port_metrics = trainer.make_train_step(
        parse_loss("SISDR"), **multi.TABLE)(
        trainer.TrainState(model=model, optimizer=opt, step=0),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.savez(out, loss_jax=float(metrics["loss"]),
             loss_port=float(port_metrics["loss"]), **grads)


def rel_l2(got, want, names):
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in names)
    return (num / sum(float((want[n] ** 2).sum()) for n in names)) ** 0.5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--child", choices=["f32", "f64"])
    ap.add_argument("--init")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        first_gradients(args.child, args.seed, args.threads, args.init,
                        args.out)
        return 0
    import numpy as np

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "grads")
        for dtype in ("f32", "f64"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", dtype, "--init", f"{base}_init.npy",
                            "--out", f"{base}_{dtype}.npz",
                            "--seed", str(args.seed),
                            "--threads", str(args.threads)],
                           check=True, env=dict(os.environ,
                                                JAX_PLATFORMS="cpu"))
            with np.load(f"{base}_{dtype}.npz") as z:
                runs[dtype] = {side: {k.split("/", 1)[1]: z[k] for k in z
                                      if k.startswith(side + "/")}
                               for side in ("jax", "port")}
                runs[dtype]["loss"] = (float(z["loss_jax"]),
                                       float(z["loss_port"]))
    f32, f64 = runs["f32"], runs["f64"]
    names = sorted(f64["port"])
    encoder = [n for n in names if n.startswith("spk_model_net.")]
    flips = []
    for n in names:
        j32, p32 = f32["jax"][n], f32["port"][n]
        firm = np.abs(j32) > 1e-2 * np.abs(j32).max()
        for i in np.argwhere(firm & (np.sign(p32) != np.sign(j32))):
            i = tuple(int(v) for v in i)
            flips.append({"leaf": n, "at": i, "f32_port": float(p32[i]),
                          "f32_jax": float(j32[i]),
                          "f64_port": float(f64["port"][n][i]),
                          "f64_jax": float(f64["jax"][n][i])})
    firm64 = 0
    for n in names:
        j64, p64 = f64["jax"][n], f64["port"][n]
        firm = np.abs(j64) > 1e-2 * np.abs(j64).max()
        firm64 += int((firm & (np.sign(p64) != np.sign(j64))).sum())
    print(json.dumps({
        "losses": {"f32": f32["loss"], "f64": f64["loss"]},
        "port_vs_jax": {d: {"all": rel_l2(r["port"], r["jax"], names),
                            "encoder": rel_l2(r["port"], r["jax"], encoder)}
                        for d, r in runs.items()},
        "f32_vs_f64": {side: {"all": rel_l2(f32[side], f64[side], names),
                              "encoder": rel_l2(f32[side], f64[side],
                                                encoder)}
                       for side in ("port", "jax")},
        "f32_sign_flips": len(flips),
        "f64_sign_is_f32_port_sign": sum(
            np.sign(f["f64_port"]) == np.sign(f["f32_port"]) for f in flips),
        "f64_sign_is_f32_jax_sign": sum(
            np.sign(f["f64_jax"]) == np.sign(f["f32_jax"]) for f in flips),
        "f64_firm_sign_flips": firm64, "flips": flips}, default=int))
    return 0


if __name__ == "__main__":
    sys.exit(main())
