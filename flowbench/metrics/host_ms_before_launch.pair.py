"""Host ms per call from the start of the port's captured call to its graph's
launch (key, copy-in, any capture: what the card waits for), the mean over
the traced window's calls: the port's own spans ``capture.call`` and
``capture.launch``, placed on the slice's clock."""

from flowbench.program import ms_before_launch


def read(r):
    return ms_before_launch(r)
