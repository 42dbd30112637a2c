from rtbench import spans


def read(r):
    """Host ms a frame in render() before and around its graph's replay:
    the span rtc.render less its rtc.graph.replay and rtc.graph.output."""
    split = spans.replay_split_ms(spans.record(), "rtc.render")
    return None if split is None else split[0]
