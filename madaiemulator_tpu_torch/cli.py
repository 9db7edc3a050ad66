"""`interactive_emulator_torch` command-line tool (port of
madaiemulator_tpu/cli.py, `interactive_mode` only).

    interactive_emulator_torch interactive_mode <state_file>
        [--dtype=float64|float32] [--device=cuda|cpu] [--serve_method=dense]

reads query points (nparams whitespace-separated floats) on stdin until EOF
and writes t means then t variances per query on stdout, "%.17g", flushing
after each batch: the pipe protocol of the JAX CLI, byte for byte. Header:
nparams, param names, 2*noutputs, then the mean_* / variance_* labels.
Every complete point already buffered on the pipe is answered in one batched
call (at most 1024 points per call).

--device cuda (the default) needs a CUDA device: without one the tool exits
2 with "error: CUDA device not available" (it never moves to the CPU by
itself). At float32 the serve path runs on the Hopper kernels; float64 (the
default) takes the library path. Also runnable as
`python -m madaiemulator_tpu_torch.cli`.
"""

from __future__ import annotations

import argparse
import os
import select
import sys
from typing import List, Optional

import numpy as np

MAX_BATCH = 1024


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="interactive_emulator_torch",
        description="PyTorch/CUDA MADAI-style Gaussian-process emulator",
    )
    sub = p.add_subparsers(dest="command", required=True)
    im = sub.add_parser("interactive_mode", help="serve queries over stdin/stdout")
    im.add_argument("state_file")
    im.add_argument("--dtype", choices=["float64", "float32"], default="float64")
    im.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    im.add_argument("--serve_method", choices=["dense"], default="dense")
    return p


def cmd_interactive_mode(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models.multivariate import predict_multivariate

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA device not available", file=sys.stderr)
        return 2
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    try:
        emu, param_names, output_names = read_snapshot(
            args.state_file, device=torch.device(args.device), dtype=dtype
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    d = len(param_names)
    out = sys.stdout
    # header: expected inputs, then produced outputs
    out.write(f"{d}\n")
    for s in param_names:
        out.write(f"{s}\n")
    out.write(f"{2 * len(output_names)}\n")
    for s in output_names:
        out.write(f"mean_{s}\n")
    for s in output_names:
        out.write(f"variance_{s}\n")
    out.flush()

    fd = sys.stdin.fileno()

    def _drain_available(buf: bytes, eof: bool):
        """Read whatever is already readable without blocking."""
        while not eof:
            r, _, _ = select.select([fd], [], [], 0)
            if not r:
                break
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
                break
            buf += chunk
        return buf, eof

    def _predict_batch(pts: np.ndarray) -> np.ndarray:
        """(m, d) -> (m, 2t) [means | variances], MAX_BATCH points a call."""
        rows = []
        for i in range(0, pts.shape[0], MAX_BATCH):
            mean, var = predict_multivariate(emu, pts[i:i + MAX_BATCH])
            rows.append(torch.cat([mean, var], dim=1).cpu().numpy())
        return np.concatenate(rows, axis=0)

    toks: List[str] = []
    buf = b""
    eof = False
    while True:
        if not eof:
            # block for at least one byte, then drain the rest
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
            else:
                buf = buf + chunk
                buf, eof = _drain_available(buf, eof)
        # split tokens; a trailing partial token stays in the byte buffer
        text = buf.decode()
        if not eof and text and not text[-1].isspace():
            cut = max(
                (text.rfind(c) for c in (" ", "\t", "\n", "\r")), default=-1
            )
            text, buf = text[: cut + 1], text[cut + 1 :].encode()
        else:
            buf = b""
        toks.extend(text.split())
        n_pts = len(toks) // d
        if n_pts:
            flat, toks = toks[: n_pts * d], toks[n_pts * d :]
            try:
                pts = np.asarray(
                    [float(v) for v in flat], dtype=np.float64
                ).reshape(n_pts, d)
            except ValueError as e:
                print(f"error: bad query token: {e}", file=sys.stderr)
                return 1
            vals = _predict_batch(pts)  # (n_pts, 2t)
            out.write("\n".join(f"{v:.17g}" for v in vals.ravel()) + "\n")
            out.flush()
        if eof and not buf:
            break
    if toks:
        print(
            f"warning: {len(toks)} trailing token(s) ignored (partial point)",
            file=sys.stderr,
        )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        if args.command == "interactive_mode":
            return cmd_interactive_mode(args)
    except BrokenPipeError:
        # the pipe consumer went away: the conventional quiet SIGPIPE exit
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        return 141
    raise AssertionError(args.command)


if __name__ == "__main__":
    sys.exit(main())
