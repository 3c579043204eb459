"""The port's static-analysis gate:

  python -m repro_torch.analyze                  # ir + lint + deadcode
  python -m repro_torch.analyze ir               # one recorded chunk each
  python -m repro_torch.analyze lint             # AST rules
  python -m repro_torch.analyze deadcode         # import reachability
  python -m repro_torch.analyze --device cpu     # ir's chunks on the CPU

The ir section records its one-process chunks on the CUDA device unless
``--device cpu`` is given (it raises when there is none); the mesh
engines' gloo rank cases are CPU processes either way.

Exit code 0 only when every finding is waived in ``waivers.txt`` beside
this module.  Run from the root of a checkout with ``src`` on the path.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analyze",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("section", nargs="?", default="all",
                    choices=["all", "ir", "lint", "deadcode"])
    ap.add_argument("--device", default=None,
                    help="device of the one-process chunks (default: the "
                    "CUDA device; cpu for the plain PyTorch versions)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="also write the findings as JSON")
    ap.add_argument("--waivers", default=None, help="waiver file")
    args = ap.parse_args(argv)
    from .runner import run_all
    text, code = run_all(
        sections=None if args.section == "all" else [args.section],
        waiver_file=args.waivers, json_path=args.json_path,
        device=args.device)
    print(text)
    return code


if __name__ == "__main__":
    sys.exit(main())
