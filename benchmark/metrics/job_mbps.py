"""Input megabases a second through the CLI: the window's jobs' bases
(FASTA in, `<obj>`, `.#`, `.$` on disk) over the window's wall time."""


def read(w):
    return w.n_builds * w.bases / 1e6 / w.seconds
