from rtbench import spans


def read(r):
    """Host ms a step in the train step before and around its graph's
    replay: the span rtc.train_step less its rtc.graph.replay and
    rtc.graph.output."""
    split = spans.replay_split_ms(spans.record(), "rtc.train_step")
    return None if split is None else split[0]
