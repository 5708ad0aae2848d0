"""``python -m repro_torch.roofline --rows dryrun.jsonl``: the roofline
table (``roofline.table``)."""
import sys

from repro_torch.roofline.table import main

sys.exit(main())
