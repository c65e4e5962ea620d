import sys

from ddim_cold_torch.analysis.cli import main

sys.exit(main())
