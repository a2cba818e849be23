"""``python -m fedml_tpu_torch`` — the single-run command line (cli.py).

The reference's subcommands are recognized and not ported yet: ``serve``,
``status`` and ``fleet`` (ROADMAP.md §1 item 10) and ``trace`` (the
cross-process trace merge, item 1)."""

import sys

_SUBCOMMANDS = {"serve": 10, "status": 10, "fleet": 10, "trace": 1}


def _entry() -> None:
    if len(sys.argv) > 1 and sys.argv[1] in _SUBCOMMANDS:
        raise NotImplementedError(
            f"python -m fedml_tpu_torch {sys.argv[1]} is not ported yet "
            f"(ROADMAP.md §1 item {_SUBCOMMANDS[sys.argv[1]]})"
        )
    from fedml_tpu_torch.cli import main

    main()


if __name__ == "__main__":
    _entry()
