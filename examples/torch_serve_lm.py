"""Serving example of the PyTorch port: batched requests through the
KV-cache engine with the MCOP prefill/decode-pool placement report.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

The counterpart of ``examples/serve_lm.py``: the same arguments to
``repro_torch.launch.serve`` (the reduced qwen3-32b, 12 requests of 16
new tokens, 4 at a time, prompts under 24 tokens, temperature 0.7), plus
``--device`` (default the GPU; without one the run raises
``KernelError``).  The placement report is host float64 and equals the
JAX example's; sampled tokens follow the same distribution, not the same
draws.
"""

import argparse
import sys

from repro_torch.launch import serve as serve_cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve_argv = [
        "--arch", "qwen3-32b",
        "--reduced",
        "--requests", "12",
        "--max-new-tokens", "16",
        "--max-batch", "4",
        "--prompt-len", "24",
        "--temperature", "0.7",
    ]
    print(f"[example] python -m repro_torch.launch.serve {' '.join(serve_argv)}")
    return serve_cli.main(serve_argv + ["--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
