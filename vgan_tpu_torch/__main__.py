"""``python -m vgan_tpu_torch``: the command-line interface
(:mod:`vgan_tpu_torch.cli`)."""

from vgan_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
