"""repro_torch.resilience — elastic, fault-tolerant time loops (port of
``repro.resilience``).

Long stencil runs survive preemption by checkpointing and resume
*elastically* — possibly onto a different mesh factorization, rank
count or epoch depth:

    from repro_torch.resilience import ResilientLoop, resume, FaultPlan

    loop = ResilientLoop(program, target, (u0,), 256,
                         directory="ckpt/", checkpoint_every=4)
    final = loop.run()                       # snapshots every 4 epochs

    # ... killed mid-run (preemption, or an injected FaultPlan) ...

    loop = resume(program, "ckpt/", new_target)   # e.g. 4 ranks -> 1
    final = loop.run()       # bitwise-equal to the uninterrupted run

- ``driver.py``   — ``ResilientLoop`` / ``resume``: the epoch-aligned
  checkpointing loop and the reshard-and-recompile resume path.
- ``faults.py``   — ``FaultPlan`` / ``SimulatedFault``: deterministic
  kill / straggler / torn-write injection (a copy of the reference's).

- ``migrate.py``  — ``evacuate`` / ``admit``: request migration between
  stencil-serving engines (``repro_torch.serve.stencil``) through
  epoch-aligned per-request checkpoints (a copy of the reference's).

The snapshot layout is the reference's, so a run or a request that
either package checkpointed resumes in the other.

Also reachable as ``repro_torch.api.resilient_loop`` /
``repro_torch.api.resume``.
"""
from repro_torch.resilience.driver import ResilientLoop, ResumeError, resume
from repro_torch.resilience.faults import FaultPlan, SimulatedFault, truncate_snapshot
from repro_torch.resilience.migrate import admit, evacuate

__all__ = [
    "FaultPlan",
    "ResilientLoop",
    "ResumeError",
    "SimulatedFault",
    "admit",
    "evacuate",
    "resume",
    "truncate_snapshot",
]
