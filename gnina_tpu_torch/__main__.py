import sys

from gnina_tpu_torch.cli import main

sys.exit(main())
