"""How much longer a step with admissions takes (ms): the median host time
of the window's steps that admitted at least one request minus the median
of those that admitted none (the harness's clock around ``step()``)."""
import statistics


def read(cell, traced):
    steps = getattr(cell, "rec", {}).get("steps", [])
    busy = [s for s, n in steps if n > 0]
    quiet = [s for s, n in steps if n == 0]
    if not busy or not quiet:
        return None
    return 1e3 * (statistics.median(busy) - statistics.median(quiet))
