#!/usr/bin/env python3
"""Train a row of the synthetic battery in the port from the JAX
package's initial weights, on the CPU: the same corpus, config, data order
and first weights as the JAX tool's run, so that what is left between the
two SI-SNRi is the training itself, not the draw of the init.

    JAX_PLATFORMS=cpu python3 tools/synthetic_from_jax_init.py --row tfgridnet
        [--seed 17] [--work_dir DIR] [--threads 4] [--jax_order]

Runs wesep_tpu.tools.validate_synthetic's row with the JAX trainer's
`init_train_state` wrapped to write the initial parameters (and batch
statistics) as a JAX bundle and stop there; then the port's
validate_synthetic row with `model_init` set to that bundle (read through
train/checkpoint.load_pretrained_model, every parameter checked to come
from it) and `device: cpu`; with `--jax_order` the port first draws one
batch as the JAX bin/train does for its init shapes, so that it reads the
same batches. Prints one JSON line. It imports both packages,
so it runs where JAX is installed, not on the card.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Stop(Exception):
    pass


def jax_init_bundle(row_kwargs, work_dir, seed, path):
    """The JAX tool's initial weights for the row, as a JAX bundle."""
    import wesep_tpu.train.trainer as jax_train
    from wesep_tpu.tools import validate_synthetic as jax_vs
    from wesep_tpu.train.checkpoint import save_checkpoint
    from wesep_tpu_torch.tools.validate_synthetic import SMALL

    init = jax_train.init_train_state

    def capture(*a, **k):
        state = init(*a, **k)
        stats = getattr(state, "batch_stats", None)
        save_checkpoint(path, [state.params],
                        batch_stats=[stats] if stats else None)
        raise _Stop

    write = jax_vs.yaml.dump

    def seeded(config, *a, **k):
        if isinstance(config, dict) and "seed" in config:
            config["seed"] = seed
        return write(config, *a, **k)

    jax_train.init_train_state = capture
    jax_vs.yaml.dump = seeded
    try:
        jax_vs.run(work_dir, **SMALL, **row_kwargs)
    except _Stop:
        pass
    finally:
        jax_train.init_train_state = init
        jax_vs.yaml.dump = write


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--row", required=True)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--jax_order", action="store_true",
                    help="draw one batch before training, as the JAX "
                    "bin/train does for its init shapes, so that the port "
                    "reads the JAX run's batches")
    args = ap.parse_args()
    import torch

    from wesep_tpu_torch.train import checkpoint
    from wesep_tpu_torch.tools import validate_synthetic as vs

    torch.set_num_threads(args.threads)
    (kwargs, floor), = [(k, f) for n, k, f in vs.FLOORS if n == args.row]
    with tempfile.TemporaryDirectory(prefix="from_jax_init_") as tmp:
        work = args.work_dir or tmp
        bundle = os.path.join(work, "jax_init.ckpt")
        os.makedirs(work, exist_ok=True)
        jax_init_bundle(kwargs, os.path.join(work, "jax"), args.seed, bundle)

        load = checkpoint.load_pretrained_model
        loaded = {}

        def strict_load(model, path, model_index=0):
            state = checkpoint.model_state(checkpoint.load_checkpoint(path),
                                           model_index)
            missing = set(model.state_dict()) - set(state)
            loaded["missing"] = sorted(missing)
            model.load_state_dict(state, strict=True)
            return model

        write = vs._write_config

        def from_init(root, config):
            config["seed"] = args.seed
            config["model_init"] = {"tse_model": bundle}
            return write(root, config)

        from wesep_tpu_torch.bin import train as port_train
        from wesep_tpu_torch.data import BatchLoader

        build = port_train.build_loaders

        def peeked(*a, **k):
            loaders = build(*a, **k)
            train_loader = loaders[0]
            train_loader.set_epoch(0)
            next(iter(BatchLoader(train_loader.dataset,
                                  batch_size=train_loader.batch_size,
                                  collate_fn=train_loader.collate_fn,
                                  prefetch=0)))
            return loaders

        if args.jax_order:
            port_train.build_loaders = peeked
        checkpoint.load_pretrained_model = strict_load
        vs._write_config = from_init
        try:
            sisnri = vs.run(os.path.join(work, "port"), device="cpu",
                            **vs.SMALL, **kwargs)
        finally:
            checkpoint.load_pretrained_model = load
            vs._write_config = write
            port_train.build_loaders = build
    print(json.dumps({"row": args.row, "seed": args.seed,
                      "jax_order": args.jax_order,
                      "port_from_jax_init_si_snri": sisnri, "floor": floor,
                      "missing_from_bundle": loaded.get("missing")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
