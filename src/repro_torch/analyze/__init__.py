"""Static contract audit of the port (``src/repro_torch``); port of
``repro.analyze``.

The contracts of the reference's gate, retargeted to eager PyTorch:

* :mod:`.ir_rules` over :mod:`.configs`: every engine x precision x
  variant runs one recorded chunk (:mod:`.ops_trace`) and is held to
  IR-A..IR-E (no float arithmetic in integer bodies, the declared wire,
  collective and host-sync counts, modular counters);
* :mod:`.lint`: AST rules over ``src/repro_torch`` (AL-RANDOM, AL-KEY,
  AL-LOCK, AL-EXCEPT);
* :mod:`.deadcode`: import-graph reachability (AL-DEAD).

Run ``python -m repro_torch.analyze [ir|lint|deadcode|all]``: it exits 0
only when every finding is waived in ``waivers.txt`` beside this module.
"""

from .findings import Finding, Waivers  # noqa: F401
from .runner import run_all, run_deadcode, run_ir, run_lint  # noqa: F401
