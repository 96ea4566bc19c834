"""Scale-out over torch.distributed ranks, one process per card: the
pass's film merged by all_reduce (sharding), whole frames dealt one per
rank (sharding.render_frames_per_chip) and the multi-process frame farm
(distributed)."""
