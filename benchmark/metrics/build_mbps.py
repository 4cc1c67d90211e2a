"""Input megabases built a second: the window's builds' bases over the
window's wall time, from the first build's start to the last one's end
after a device sync (a library user's rate; a stall anywhere counts)."""


def read(w):
    return w.n_builds * w.bases / 1e6 / w.seconds
