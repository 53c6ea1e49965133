"""Host GC tuning after an engine's warm-up (counterpart of
``dsm_tpu/utils/gc_tune.py``).

CPython's generational GC walks every tracked container when a gen2
collection triggers.  After the engines have built their weights, states and
captured graphs the process holds many long-lived objects, and a full sweep
over them stalls the one thread that feeds the card.  The engines call
:func:`freeze_after_warmup` at the end of ``warmup()``:

* ``gc.collect()`` once, to clear construction garbage;
* ``gc.freeze()``, which moves every live object out of all later
  collections, so steady-state sweeps walk only what serving allocates;
* raise the thresholds so that the per-tick churn (numpy views, event
  objects) is absorbed by gen0/gen1 without frequent full sweeps.

The switch is the caller's argument (each engine's ``gc_tune``); no
environment variable is read.
"""

from __future__ import annotations

import gc


def freeze_after_warmup(enabled: bool = True) -> bool:
    """Collect, freeze the heap and raise the collection thresholds.
    Repeated calls freeze newly long-lived objects and keep the thresholds.
    Returns whether tuning ran."""
    if not enabled:
        return False
    gc.collect()
    gc.freeze()
    g0, g1, g2 = gc.get_threshold()
    gc.set_threshold(max(g0, 50_000), max(g1, 50), max(g2, 50))
    return True
