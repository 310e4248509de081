"""``python -m spark_agd_tpu_torch.obs``: schema tooling.

A copy of ``spark_agd_tpu/obs/__main__.py``; ``tests/test_torch_obs.py``
holds everything after this docstring to the original, line for line
(so the usage line names the JAX package's program).  ``--selfcheck``
validates the example records against ``obs.schema`` (plus a JSON round
trip and a negative control) and exits nonzero on any failure;
``--validate FILE.jsonl`` validates every record of a file.
"""

from __future__ import annotations

import argparse
import sys

from . import schema


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spark_agd_tpu.obs", description=__doc__)
    p.add_argument("--selfcheck", action="store_true",
                   help="validate the example records against the "
                        "canonical schema; exit 1 on any failure")
    p.add_argument("--validate", metavar="FILE.jsonl",
                   help="validate every record in a JSONL file; exit 1 "
                        "if any record fails")
    args = p.parse_args(argv)
    if args.selfcheck:
        ok, msgs = schema.selfcheck()
        for m in msgs:
            print(m)
        return 0 if ok else 1
    if args.validate:
        bad = 0
        recs = schema.read_jsonl(args.validate)
        for i, rec in enumerate(recs, 1):
            errs = schema.validate_record(rec)
            if errs:
                bad += 1
                print(f"{args.validate}: record {i}: {'; '.join(errs)}")
        print(f"{args.validate}: {len(recs)} records, {bad} invalid")
        return 1 if bad else 0
    p.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
