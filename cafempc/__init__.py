"""cafempc — a cascaded-fidelity MPC / trajectory-optimization framework
in JAX (XLA, with a Pallas/Triton kernel for the GPU).

Re-implements, batched for an accelerator, the capability surface of the
CAFE-MPC reference stack (multi-phase Hybrid-Systems DDP with AL/ReB constraint
handling, whole-body + SRB cascaded horizons, the HKD kinodynamic model,
reference management, and the MPC runtime), re-designed around:

  * flat, statically-shaped multi-phase knot plans (masked reset maps)
    instead of heterogeneous phase deques,
  * `vmap`-parallel multiple-shooting rollouts (every knot is a shooting
    state, so the forward sweep has no sequential dependence),
  * `lax.scan` (and associative-scan) Riccati backward sweeps,
  * scenario batching via `vmap` + `shard_map` over device meshes.

Reference (studied, not copied): ruihuang1124/CAFE-MPC.
"""

__version__ = "0.1.0"
