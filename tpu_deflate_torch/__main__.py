import sys

from tpu_deflate_torch.cli import main

sys.exit(main())
