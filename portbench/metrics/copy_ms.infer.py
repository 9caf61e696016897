"""Device milliseconds of copies a posteriors call (the features up, the
scores down), from the profiled sub-window's device trace."""


def read(records):
    profile = records["profile"]
    copies = [dur for name, _, dur in profile["copies"]
              if name.startswith("Memcpy")]
    if not profile["steps"] or not copies:
        return None
    return sum(copies) / profile["steps"] / 1e3
