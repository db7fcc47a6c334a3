"""Profiling, timing and checkpointing — port of `phiflow_tpu.utils`.

`profile` / `profile_function` trace a run with `torch.profiler` (a Chrome
trace written into a directory, device kernels included on the card);
`benchmark` and `Timer` time on the host clock, `benchmark` waiting for the
card (`torch.cuda.synchronize`) before each reading; `save_checkpoint`,
`load_checkpoint` and `CheckpointManager` keep any state of the port's
structures (Tensors, Fields, tuples, lists, dicts, torch tensors) as one
pickle a checkpoint with host copies of its arrays, written atomically, and
load it onto a chosen device.
"""
from ._profile import profile, profile_function, benchmark, Timer
from ._checkpoint import CheckpointManager, save_checkpoint, load_checkpoint
