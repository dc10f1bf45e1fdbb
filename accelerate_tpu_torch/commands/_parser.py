"""Argument-parser base shared by every CLI subcommand (the JAX package's
``commands/_parser.py``).

Reference parity (``commands/utils.py CustomArgumentParser``): every
``--foo_bar`` flag is also accepted as ``--foo-bar`` — done here by
registering the hyphen spelling as a real argparse alias at ``add_argument``
time (argparse derives ``dest`` from the first long option, so the underscore
form stays canonical).  Positional arguments and the user script's own args
(``argparse.REMAINDER``) are untouched.
"""

from __future__ import annotations

import argparse

__all__ = ["DualDashParser"]


class DualDashParser(argparse.ArgumentParser):
    def __init__(self, *args, **kwargs):
        # Prefix abbreviation would make every underscore flag ambiguous with
        # its own hyphen alias ("--config" vs --config_file/--config-file);
        # the root accelerate-tpu parser already disables it.
        kwargs.setdefault("allow_abbrev", False)
        super().__init__(*args, **kwargs)

    def add_argument(self, *names, **kwargs):
        expanded = []
        for n in names:
            expanded.append(n)
            if isinstance(n, str) and n.startswith("--") and "_" in n[2:]:
                alias = "--" + n[2:].replace("_", "-")
                if alias not in expanded:
                    expanded.append(alias)
        return super().add_argument(*expanded, **kwargs)
