"""System adapters: how a configuration's system is built, warmed, sent a
request and held to its reference. A configuration's file names its
adapter (`"system"`), a module here with a `System` class:

* `System(config, traffic, seed, device, trace)` builds the program from
  the seed (set-up) and warms the shapes the traffic uses;
* `request(spec, record)`: one request through the program's entry, on a
  client thread, filling the `loop.Record`;
* `counters()`: a snapshot of the program's counters;
* `observe(records, t0, t1, before, after)`: what the metric readers need
  beyond the records and the trace;
* `release()`: the program's state freed, after the peak is read;
* `check(records)`: [(name, value, limit)] from the plain reference.
"""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}").System
