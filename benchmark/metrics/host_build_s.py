"""``host_build_s``: the seconds set-up spends building the cell's
sequencers (the merge, the pads, the operators, the copies to the device),
read from the benchmark's span around their construction."""


def read(record):
    return record["spans"].get("host_build_s")
