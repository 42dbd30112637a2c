from rtbench import spans


def read(r):
    """Host ms a frame in render() in its graph's replay: the span
    rtc.graph.replay under rtc.render."""
    split = spans.replay_split_ms(spans.record(), "rtc.render")
    return None if split is None else split[1]
