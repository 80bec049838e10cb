"""Mean part of a round that is not fetching: the round's duration less
its fetch wall time (first fetch's start to last fetch's end), from the
traced run's timed fetches."""


def read(window: dict) -> float | None:
    rounds, fetch = window.get("rounds_ms"), window.get("fetch_wall_ms")
    if not rounds or not fetch or len(rounds) != len(fetch):
        return None
    return sum(r - f for r, f in zip(rounds, fetch)) / len(rounds)
