"""The multi-device tier: one process a device over a torch.distributed
process group (mesh, collectives, dist, sprank)."""

__all__ = ["make_mesh", "dist_build_bwt", "init_distributed"]


def __getattr__(name):
    if name in ("make_mesh", "init_distributed"):
        from debwt_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name == "dist_build_bwt":
        from debwt_tpu_torch.parallel.dist import dist_build_bwt

        return dist_build_bwt
    raise AttributeError(name)
