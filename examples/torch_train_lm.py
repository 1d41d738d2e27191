"""Training example of the PyTorch port: the reduced qwen2-7b decoder
(``reduce_config``: width 64, 2 layers, a vocabulary of 256, about 0.1M
parameters, as the launcher prints) trained on the synthetic pipeline,
with checkpoint/resume and an MCOP placement report.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

The counterpart of ``examples/train_lm.py``: the same arguments to
``repro_torch.launch.train`` (sequences of 128 tokens, a global batch of 16
in 2 microbatches, lr 1e-3, a checkpoint every 100 steps), plus
``--device`` (default the GPU; without one the run raises
``KernelError``).  A second run on the same ``--ckpt-dir`` resumes from
its latest checkpoint.  The published-width training of the same launcher
is ``python -m repro_torch.launch.train --arch <arch>`` without
``--reduced``.
"""

import argparse
import os
import sys
import tempfile

from repro_torch.launch import train as train_cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    train_argv = [
        "--arch", "qwen2-7b",
        "--reduced",
        "--steps", str(args.steps),
        "--seq-len", "128",
        "--global-batch", "16",
        "--n-micro", "2",
        "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "20",
    ]
    print(f"[example] python -m repro_torch.launch.train {' '.join(train_argv)}")
    return train_cli.main(train_argv + ["--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
