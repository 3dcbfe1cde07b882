"""The device's idle share of the traced stretch, in %:
100 · (1 − the union of device-busy intervals ÷ the stretch's wall time)."""


def idle_share(record, kind: str):
    trace = record.get("trace")
    if record["kind"] != kind or not trace or record["stretch_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / record["stretch_s"])
