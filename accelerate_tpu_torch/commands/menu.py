"""Arrow-key selection menu for the config questionnaire.

Parity target: reference ``commands/menu/`` (cursor.py/input.py/keymap.py/
selection_menu.py, ~277 LoC): a BulletMenu the questionnaire uses for every
multiple-choice question.  Same UX here — up/down (or j/k) to move, enter to
pick — in one module: raw-mode key reading via termios, cursor repositioning
via ANSI escapes.  When stdin is not a TTY (tests, CI, piped input) the menu
falls back to a numbered prompt read with ``input()``, which is what makes
every flow drivable by answer injection.
"""

from __future__ import annotations

import sys

__all__ = ["BulletMenu"]


def _read_key() -> str:
    """One keypress from raw stdin; arrows normalize to 'up'/'down'.

    ESC handling must not block or leak bytes: a bare Escape press has no
    tail, and CSI sequences vary in length (arrows send ``[A``, Home/End/
    PgUp send e.g. ``[1~``) — so the tail is read with a short ``select``
    timeout and drained to the CSI final byte (0x40-0x7e) instead of a fixed
    2-byte read, which would hang on bare ESC and leave ``~`` in the stream
    to be misread as a command."""
    import os as _os
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)

    # All IO happens at the fd level (os.read): sys.stdin is a buffered
    # TextIOWrapper, so mixing sys.stdin.read with select() on the fd would
    # see an empty fd while bytes sit in Python's buffer — every arrow key
    # would misread as 'esc'.
    def _pending(timeout: float = 0.05) -> bool:
        return bool(select.select([fd], [], [], timeout)[0])

    def _read1() -> str:
        return _os.read(fd, 1).decode("latin-1")

    try:
        tty.setraw(fd)
        ch = _read1()
        if ch == "\x1b":  # escape (possibly the start of a CSI sequence)
            if not _pending():
                return "esc"  # bare Escape keypress
            tail = _read1()
            if tail != "[":
                # SS3 (ESC O <final>, keypad/application mode) and alt-<key>
                # sequences: drain any pending tail bytes so they are not
                # re-read as commands, then treat as esc.
                while _pending(0.01):
                    _read1()
                return "esc"
            # CSI: parameter bytes 0x30-0x3f and intermediates 0x20-0x2f,
            # then one final byte 0x40-0x7e terminates the sequence.
            seq = ""
            while _pending():
                b = _read1()
                seq += b
                if "\x40" <= b <= "\x7e":
                    break
            if seq == "A":
                return "up"
            if seq == "B":
                return "down"
            return "esc"
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


class BulletMenu:
    """``BulletMenu(prompt, choices).run(default) -> index``."""

    def __init__(self, prompt: str, choices: list):
        self.prompt = prompt
        self.choices = [str(c) for c in choices]

    def _interactive(self, default: int) -> int:
        n = len(self.choices)
        pos = default
        print(self.prompt)
        for i, c in enumerate(self.choices):
            print(("➔  " if i == pos else "   ") + c)
        while True:
            key = _read_key()
            if key in ("up", "k"):
                pos = (pos - 1) % n
            elif key in ("down", "j"):
                pos = (pos + 1) % n
            elif key in ("\r", "\n"):
                # Clear the menu so the questionnaire reads linearly after.
                sys.stdout.write(f"\x1b[{n + 1}A\x1b[J")
                print(f"{self.prompt} {self.choices[pos]}")
                return pos
            elif key.isdigit() and int(key) < n:
                pos = int(key)
            elif key in ("\x03", "q"):  # Ctrl-C
                raise KeyboardInterrupt
            else:
                continue
            sys.stdout.write(f"\x1b[{n}A")
            for i, c in enumerate(self.choices):
                sys.stdout.write("\x1b[2K" + ("➔  " if i == pos else "   ") + c + "\n")
            sys.stdout.flush()

    def _numbered(self, default: int) -> int:
        print(self.prompt)
        for i, c in enumerate(self.choices):
            print(f"  [{i}] {c}")
        while True:
            raw = input(f"Choice (0-{len(self.choices) - 1}) [{default}]: ").strip()
            if not raw:
                return default
            try:
                idx = int(raw)
            except ValueError:
                print("Please enter a number.")
                continue
            if 0 <= idx < len(self.choices):
                return idx
            print(f"Out of range 0-{len(self.choices) - 1}.")

    def run(self, default: int = 0) -> int:
        if sys.stdin.isatty() and sys.stdout.isatty():
            try:
                return self._interactive(default)
            except (ImportError, OSError):
                pass  # no termios (or raw mode refused): numbered fallback
        return self._numbered(default)
