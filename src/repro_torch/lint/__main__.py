"""Entry point: ``python -m repro_torch.lint``."""
import sys

from repro_torch.lint.runner import main

sys.exit(main())
