"""Runtime helpers of the port: checkpoints of the train state and the
LATEST-marker commit protocol (``checkpoint``); failure detection, straggler
mitigation, elastic re-meshing, the restarting runner and crash injection
(``fault_tolerance``)."""
