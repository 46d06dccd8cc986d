"""Plot the train and validation loss curves of a bin/train log.

Counterpart of wesep_tpu/tools/print_train_val_curve.py: the log's
"Epoch N train_loss X val_loss Y" lines (wesep_tpu_torch.bin.train writes
one an epoch) as two curves over the epochs, saved as an image. The plot
needs matplotlib, imported only here in `main`; without it the tool says
so and exits.

    python -m wesep_tpu_torch.tools.print_train_val_curve \
        exp/BSRNN/train.log out.png
"""

import argparse
import re

_EPOCH = re.compile(r"Epoch (\d+) train_loss ([-\d.]+) val_loss ([-\d.]+)")


def parse_log(path):
    """-> (epochs, train losses, validation losses) of the log's epoch
    lines, in order."""
    epochs, train, val = [], [], []
    with open(path) as f:
        for line in f:
            m = _EPOCH.search(line)
            if m:
                epochs.append(int(m.group(1)))
                train.append(float(m.group(2)))
                val.append(float(m.group(3)))
    return epochs, train, val


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("log")
    parser.add_argument("out_png")
    args = parser.parse_args(argv)
    epochs, train, val = parse_log(args.log)
    if not epochs:
        raise SystemExit("no epoch lines found in the log")
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("print_train_val_curve needs matplotlib, which is "
                         "not installed; the log holds "
                         f"{len(epochs)} epochs") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.title("Loss of Train and Validation")
    plt.plot(epochs, train, "b-", label="Train Loss", linewidth=0.8)
    plt.plot(epochs, val, "c-", label="Validation Loss", linewidth=0.8)
    plt.legend()
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.savefig(args.out_png)
    print(f"wrote {args.out_png} ({len(epochs)} epochs)")


if __name__ == "__main__":
    main()
