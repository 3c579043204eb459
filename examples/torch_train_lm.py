"""End-to-end LM training on the PyTorch/CUDA port.

The port of ``examples/train_lm.py``: a thin wrapper over
``repro_torch.launch.train`` that trains an assigned-pool arch on the
synthetic Markov stream with checkpoint/restart (a second run resumes
from the newest checkpoint).  With no arguments it trains the reduced
mamba2-370m config, as the reference does, on the card, with its
checkpoints under the temp directory.

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
  PYTHONPATH=src python examples/torch_train_lm.py --arch jamba-v0.1-52b \\
      --reduced --steps 60 --sync-every 4 --mesh data=2,model=1
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "mamba2-370m", "--reduced", "--steps", "120",
            "--batch", "8", "--seq", "64",
            "--ckpt", os.path.join(tempfile.gettempdir(), "repro_torch_ck"),
            "--ckpt-every", "60"]


def main(argv=None):
    """The reference's defaults when nothing but ``--device`` is given;
    ``launch.train.main``'s result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = []
    if "--device" in argv:
        i = argv.index("--device")
        dev, argv = argv[i:i + 2], argv[:i] + argv[i + 2:]
    return train_main((argv or DEFAULTS) + dev)


if __name__ == "__main__":
    main()
