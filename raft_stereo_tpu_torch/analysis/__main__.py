import sys

from raft_stereo_tpu_torch.analysis.cli import main

sys.exit(main())
