"""ba_accepted_share: the share of Levenberg-Marquardt steps that bundle
adjustment accepted, in %: 100 x the port's ``ba.accepted`` counter over
its ``ba.lm_steps``, over the whole window."""

from portbench.program import get, ratio


def read(data):
    p = data.program
    return ratio(get(p, "window", "ba.accepted"), get(p, "window", "ba.lm_steps"), 100.0)
