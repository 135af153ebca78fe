"""95th percentile, over every batch of every image of the window, of the
progressive user's wait for that batch's snapshot: from the request's
submission, or from the snapshot before, until the batch's sum is in host
memory."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.gaps, 95)) * 1e3 if rec.gaps else None
