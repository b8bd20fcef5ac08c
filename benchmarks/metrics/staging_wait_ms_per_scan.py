"""Time the replay loop waited for the staging thread's next segment
(``io.rosbag.StreamingStager.wait_s``), summed over the window's segments
and divided by its scans."""

UNIT = "ms"


def read(r):
    waits = getattr(r.drive, "stager_wait_s", None)
    if not waits:
        return None
    return sum(waits) * 1e3 / r.rec.n_scans
