"""Small shared utilities."""

from __future__ import annotations

import logging
import re
import threading
from collections import Counter

#: --engine values; "tpu" is the former name of "device", still accepted
ENGINES = ("auto", "host", "device", "tpu")


def camel_to_gnu(name: str) -> str:
    """camelCase -> gnu-style-option-name (fgbio StringUtil.camelToGnu, used
    for the aligner_other_parameters column, SearchReference.scala:496-508)."""
    return re.sub(r"(?<!^)(?=[A-Z])", "-", name).lower()


def scala_option_repr(v) -> str:
    """Render an optional value the way Scala's Option.toString does —
    AlignToReference interpolates Option values directly into its
    parameter string (AlignToReference.scala:77-86)."""
    return "None" if v is None else f"Some({v})"


class ProgressLogger:
    """Throughput progress logging (reference: fgbio ProgressLogger —
    every `unit` records, SearchReference.scala:531,579)."""

    def __init__(self, logger, noun: str = "records", verb: str = "Processed",
                 unit: int = 25_000):
        import time as _time

        self._logger = logger
        self._noun = noun
        self._verb = verb
        self._unit = unit
        self._count = 0
        self._start = _time.monotonic()

    def record(self, chrom: str = "", pos: int = 0, n: int = 1) -> None:
        import time as _time

        self._count += n
        if self._count % self._unit < n:
            elapsed = _time.monotonic() - self._start
            rate = self._count / elapsed if elapsed > 0 else 0.0
            where = f" Last {self._noun[:-1]}: {chrom}:{pos}." if chrom else ""
            self._logger.info(
                "%s %s %s. Elapsed %.0fs (%.0f/s).%s",
                self._verb, f"{self._count:,}", self._noun, elapsed, rate, where,
            )


#: Exception types that always indicate a host-side programming error.
#: The degradation policy (device failure degrades to host alignment,
#: never aborts — SearchReference.scala:555-559's log-and-continue
#: intent) must NOT swallow these: a silent 100x slowdown over a bug is
#: worse than a crash that gets the bug fixed.
_PROGRAMMING_ERRORS = (
    RecursionError,
    TypeError,
    ValueError,  # numpy reshape/stack shape bugs raise this
    AssertionError,
    AttributeError,
    NameError,
    UnboundLocalError,
    IndexError,
    KeyError,
    SyntaxError,
)


def degradable(exc: BaseException) -> bool:
    """True if ``exc`` is a device/runtime-ish failure the screen paths
    may degrade on (falling back to host alignment with identical
    output); False for programming errors, which must propagate.

    Exceptions raised by jax/jaxlib themselves are degradable even when
    their Python type is a builtin (jax raises ValueError for some
    device/sharding mismatch states after a backend drop): a device
    runtime failure must degrade, never abort.  Tracer/concretization errors
    (jax.errors.JAXTypeError/JAXIndexError trees) are the exception —
    they are programming errors by jax's own contract and must surface,
    not silently disable the device screen."""
    mod = type(exc).__module__ or ""
    if mod == "jax" or mod.startswith("jax.") or mod.startswith("jaxlib"):
        try:
            import jax

            if isinstance(
                exc, (jax.errors.JAXTypeError, jax.errors.JAXIndexError)
            ):
                return False
        except Exception:
            pass
        return True
    return not isinstance(exc, _PROGRAMMING_ERRORS)


_DEGRADED: Counter = Counter()
_DEGRADED_LOCK = threading.Lock()


def note_degraded(where: str, detail: str = "") -> None:
    """Count and log one fall-back from the device to the host engine
    (output stays identical; only speed is lost).  ``where`` names the
    site; :func:`degradations` reads the counts, so a run that was meant
    to stay on the device can check that it did."""
    with _DEGRADED_LOCK:
        _DEGRADED[where] += 1
    logging.getLogger("calitas_tpu.degraded").warning(
        "Device path degraded to host alignment at %s%s.", where,
        f" ({detail})" if detail else "", exc_info=True,
    )


def degradations() -> dict:
    """Degradation counts since start (or the last reset), by site."""
    with _DEGRADED_LOCK:
        return dict(_DEGRADED)


def reset_degradations() -> None:
    with _DEGRADED_LOCK:
        _DEGRADED.clear()
