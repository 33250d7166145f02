"""Terminal UI toolkit: themed console, line input, instant keypress menus
(the JAX package's ui.py).

``rich`` and ``prompt_toolkit`` are imported inside the functions that use
them, never at import: ``console`` and ``THEME`` are module-level objects
that build the themed rich ``Console`` and its ``Theme`` at their first use. So this module, and ``io``,
``voices``, ``sessions`` and ``app`` above it, import where neither package
is installed, and a session runs there with a stand-in console in place of
the modules' ``console``. Without ``prompt_toolkit`` the prompts read lines
with ``input()``.
"""

from __future__ import annotations

import os
import re
import sys

# Style names referenced by every layer above (io, voices, sessions, app).
THEME_STYLES = {
    "accent": "bold cyan",
    "ok": "bold green",
    "warn": "yellow",
    "err": "bold red",
    "dim": "grey58",
    "key": "bold magenta",
    "banner": "bold bright_cyan",
}


class ThemedTheme:
    """The app's rich ``Theme`` (THEME_STYLES), built at its first use:
    ``rich()`` is the Theme itself, and every attribute is the Theme's."""

    def __init__(self):
        self._theme = None

    def rich(self):
        if self._theme is None:
            from rich.theme import Theme

            self._theme = Theme(THEME_STYLES)
        return self._theme

    def __getattr__(self, name):
        return getattr(self.rich(), name)


THEME = ThemedTheme()


class ThemedConsole:
    """The app's one rich ``Console`` (THEME, no highlighting), built at
    the first attribute read; every attribute is the Console's."""

    def __init__(self):
        self._console = None

    def __getattr__(self, name):
        if self._console is None:
            from rich.console import Console

            self._console = Console(theme=THEME.rich(), highlight=False)
        return getattr(self._console, name)


console = ThemedConsole()


class BackSignal(Exception):
    """Raised when the user presses Escape in an instant menu (back)."""


def panel(body: str, *, title: str | None = None,
          border_style: str = "accent"):
    """A rich ``Panel`` of ``body``; where rich is not installed (so the
    console in use is a stand-in), its title and body as plain text."""
    try:
        from rich.panel import Panel
    except ImportError:
        return body if title is None else f"{title}\n{body}"
    return Panel(body, title=title, border_style=border_style)


def markup_to_ansi(markup: str) -> str:
    """Render Rich markup to an ANSI string for prompt_toolkit prompts."""
    with console.capture() as cap:
        console.print(markup, end="")
    return cap.get()


def safe_line_input(prompt_markup: str = "") -> str:
    """Read one line, rendering the prompt with Rich styling.

    Falls back to plain ``input()`` whenever stdin is not a TTY (tests,
    pipes). Ctrl-D raises EOFError to the caller; Ctrl-C propagates.
    """
    if not sys.stdin.isatty():
        if prompt_markup:
            console.print(prompt_markup, end="")
        return input()
    try:
        from prompt_toolkit import prompt as pt_prompt
        from prompt_toolkit.formatted_text import ANSI

        return pt_prompt(ANSI(markup_to_ansi(prompt_markup)))
    except (ImportError, OSError):
        if prompt_markup:
            console.print(prompt_markup, end="")
        return input()


def instant_menu_choice(
    valid_keys: set[str] | dict,
    prompt_markup: str = "[dim]Press a key…[/dim] ",
    *,
    allow_escape: bool = True,
    echo: bool = True,
) -> str:
    """Block until the user presses one of ``valid_keys`` and return it.

    Single keypress (no Enter), case-insensitive matching (the canonical
    key from ``valid_keys`` is returned), Escape raises :class:`BackSignal`
    when allowed, Ctrl-C raises KeyboardInterrupt, and the chosen key is
    echoed. On a non-TTY stdin this degrades to line input (first character
    wins), keeping tests and piped usage working.
    """
    keys = {str(k) for k in valid_keys}
    lower_map = {k.lower(): k for k in keys}

    def _resolve(ch: str) -> str | None:
        if ch in keys:
            return ch
        return lower_map.get(ch.lower())

    def _line_fallback() -> str:
        while True:
            line = safe_line_input(prompt_markup).strip()
            if not line:
                continue
            if allow_escape and line in ("\x1b", "esc", "ESC", "b!"):
                raise BackSignal()
            got2 = _resolve(line[0])
            if got2 is not None:
                return got2

    if not sys.stdin.isatty():
        return _line_fallback()

    try:
        from prompt_toolkit.input import create_input
        from prompt_toolkit.keys import Keys
    except ImportError:
        return _line_fallback()

    console.print(prompt_markup, end="")
    inp = create_input()
    try:
        with inp.raw_mode():
            while True:
                # read_keys() does not block: wait on the fd so the menu
                # idles at 0% CPU between keypresses
                try:
                    import select

                    select.select([inp.fileno()], [], [], 0.25)
                except (OSError, ValueError):
                    pass
                for press in inp.read_keys():
                    if press.key == Keys.ControlC:
                        raise KeyboardInterrupt
                    if press.key == Keys.ControlD:
                        raise EOFError
                    if press.key == Keys.Escape and allow_escape:
                        console.print()
                        raise BackSignal()
                    data = press.data or ""
                    got = _resolve(data) if data else None
                    if got is not None:
                        if echo:
                            console.print(f"[key]{got}[/key]")
                        return got
    finally:
        inp.close()


def clear_screen() -> None:
    """Clear the terminal."""
    os.system("cls" if os.name == "nt" else "clear")


def normalize_whitespace(text: str) -> str:
    """Collapse all whitespace runs to single spaces and strip."""
    return re.sub(r"\s+", " ", text).strip()


def confirm_overwrite(label: str) -> bool:
    """Ask a y/n question about overwriting ``label``; default no."""
    console.print(f"[warn]'{label}' already exists. Overwrite? (y/n)[/warn]")
    try:
        answer = safe_line_input("> ").strip().lower()
    except (EOFError, KeyboardInterrupt):
        return False
    return answer in ("y", "yes")


def print_banner(subtitle: str = "PyTorch · CUDA") -> None:
    """Render the app banner."""
    from rich.panel import Panel
    from rich.text import Text

    title = Text("QWEN3-TTS", style="banner")
    title.append("  ·  ", style="dim")
    title.append(subtitle, style="dim")
    console.print(Panel(title, border_style="accent", expand=False))
