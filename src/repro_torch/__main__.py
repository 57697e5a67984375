"""Entry point for ``python -m repro_torch`` (see repro_torch/api/cli.py)."""
from repro_torch.api.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
