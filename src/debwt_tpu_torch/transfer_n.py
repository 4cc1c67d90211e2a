"""Standalone N-removal prep tool (transferN equivalent).

The reference ships this as a separate binary (otherTool/transferN.c):
it replaces every IUPAC ambiguity code with a random compatible base,
re-wraps the FASTA at 70 columns, and reports the minimum read length.
Usage:

    python -m debwt_tpu_torch.transfer_n input.fa[.gz] output.fa [--seed N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="transfer-n",
        description="replace IUPAC ambiguity codes with random bases "
        "(reference otherTool/transferN.c equivalent)",
    )
    p.add_argument("source")
    p.add_argument("output")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--width", type=int, default=70)
    args = p.parse_args(argv)

    from debwt_tpu_torch.io import read_reads

    codes, lengths, names = read_reads(args.source, "random", args.seed)
    bases = np.array(list("ACGT"))
    min_len = int(lengths.min())
    ends = np.cumsum(lengths)
    with open(args.output, "w") as f:
        for name, e, n in zip(names, ends, lengths):
            f.write(f">{name}\n")
            s = "".join(bases[codes[e - n : e]])
            for j in range(0, len(s), args.width):
                f.write(s[j : j + args.width] + "\n")
    print(f"[transfer-n] {len(names)} reads; min read length {min_len}",
          file=sys.stderr)
    if min_len <= 32:
        print("[transfer-n] warning: reads of length <= 32 will be "
              "rejected by BWT construction (reference requirement)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
