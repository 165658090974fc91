"""Share of the traced solve in which no operation ran on the device:
1 - the union of device intervals over the traced window."""
LAYER = "device (H100)"
UNIT = "%"
MOVES = "ba_solves_per_min"
SOURCE = "device_trace"


def read(record):
    tr = record["trace"]
    busy = tr.busy_s()
    if busy <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
