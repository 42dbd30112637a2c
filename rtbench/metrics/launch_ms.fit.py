from rtbench import spans


def read(r):
    """Host ms a step in the train step in its graph's replay: the span
    rtc.graph.replay under rtc.train_step."""
    split = spans.replay_split_ms(spans.record(), "rtc.train_step")
    return None if split is None else split[1]
