import sys

from gcn_recommendation_tpu_torch.cli import main

sys.exit(main())
