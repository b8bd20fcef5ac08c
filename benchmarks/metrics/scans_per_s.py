"""Scans whose poses reached the host in the window, over the window's
length (host clock)."""

UNIT = "scans/s"


def read(r):
    return r.rec.scans_per_s()
