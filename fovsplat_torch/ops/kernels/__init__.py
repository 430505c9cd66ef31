"""The port's CUDA kernels (csrc/), one wrapper module each.

Every wrapper counts its launches in a plain integer attribute: `launches`
(and blend_fov's `launches_tile0`). launch_counters lists them in one
place, for the CUDA graphs of utils/graphs, which add a graph's captured
launches to the counters on every replay.
"""


def launch_counters() -> dict:
    """{name: (wrapper, attribute)} of every kernel launch counter; the
    name is the wrapper's, or its own for blend_fov's tile-range count."""
    # Imported here: the wrappers import modules of ops/ that import this
    # package.
    from fovsplat_torch.ops.kernels import (
        blend_fov, blend_fwd, blend_stats, build_table, compact_table,
        expand_fov, expand_ps1, hvs_loss, project_sh, segment_reduce, ssim)
    wrappers = (build_table.build_table, build_table.build_table_ps1,
                expand_fov.expand_fov, blend_fov.blend_fov,
                expand_ps1.expand_ps1, blend_fwd.blend_forward,
                blend_fwd.blend_backward, blend_fwd.blend_forward_q,
                segment_reduce.reduce_by_sorted_gid, blend_stats.blend_stats,
                compact_table.compact_table, project_sh.project_sh_forward,
                project_sh.project_sh_backward, hvs_loss.hvs_level_forward,
                hvs_loss.hvs_stats_loss, hvs_loss.hvs_stats_backward,
                hvs_loss.hvs_level_backward, ssim.ssim_forward,
                ssim.ssim_backward)
    counters = {w.__name__: (w, "launches") for w in wrappers}
    counters["blend_fov_tile0"] = (blend_fov.blend_fov, "launches_tile0")
    return counters
