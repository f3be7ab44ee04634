"""setup_s: seconds from the process's start to the first timed step:
imports, kernel builds or their cache, data and weights made from the
seed, the checked steps and the warm-up (host clock)."""


def read(r):
    return r.get('setup_s')
