"""The benchmark's plain reference: a frozen copy of the port's host
verifier and what it needs, from ``swirl_torch`` at commit 484cae3, so that
no later change to the program moves what judges it.

Copied whole: ``params``, ``codec``, ``transcript``, ``keygen``,
``postcard_vk``, ``symbolic``, ``poly``, ``air``, ``proof``,
``fields/{babybear,ext}``, ``hash/constants``, ``verifier/*``,
``testing/synthetic`` and ``models/keccak`` (the AIRs). Changed from the
copy:

- ``hash/poseidon2``: the host numpy half only, without the C++ library;
- ``prover/stacked_pcs``, ``prover/dag_eval``: the verifier's halves only
  (``StackedLayout``; ``HostEvaluator``, ``eval_nodes``);
- ``transcript``: the grind without the C++ library;
- ``verifier/whir``: a round's opened leaves and Merkle paths hashed as
  one batch, and the final polynomial evaluated at all query points at
  once (the same checks, in numpy's time);
- ``verifier.verify`` returns the batch sumcheck's point r;
- ``keygen``: the vk pre-hash kept by its bytes' sha256 when
  ``PRE_HASH_DIR`` is set.

New: ``openings`` (each trace column's value at r, plain PyTorch).
Nothing here imports the program.
"""
