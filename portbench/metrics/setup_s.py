"""Set-up: from the harness process's start to the window's first instant
(the card's job loaded and warm, the program started, warmed and ready)."""


def read(window: dict) -> float | None:
    return window.get("setup_s")
