"""Share of the time inside the program's ``serve.predict`` spans
(`inference/model_family.py:HSTUModelFamily.predict`, its whole body) in
which no kernel, copy or fill ran on the card, over the profiled Server
sub-window: the idle time a predict leaves on the card while the host
launches its work, apart from the waits between queries. Null where the
trace holds no such span."""

from harness.spans import idle_share

SOURCE = "device_trace"
LAYER = "serving"
MOVES = "serve_p95_ms"
SPAN = "serve.predict"


def read(run):
    return idle_share(run, SPAN)
