#!/usr/bin/env python3
"""Repo-root launcher of the PyTorch port, the counterpart of ``cli.py``:
``python cli_torch.py [--cpu] --override key=value ...`` (see
``zdcsim_torch/cli.py``)."""

import sys

from zdcsim_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
