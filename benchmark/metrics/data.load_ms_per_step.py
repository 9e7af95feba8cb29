"""Milliseconds of host time in each ``next()`` on the training loader
(read, augment, collate), timed around the loader by the traffic kind, over
the steps of the window."""


def read(records):
    if not records.get("steps"):
        return None
    return 1e3 * records["load_s"] / records["steps"]
