"""``python -m volsync_tpu_torch.analysis`` (ports
``volsync_tpu/analysis/__main__.py``)."""

from volsync_tpu_torch.analysis.cli import main

raise SystemExit(main())
