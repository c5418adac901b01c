"""Streaming rules (the CEP tier) of the port.

``model`` — declarative rule sets (threshold / windowed aggregate /
sequence / absence over device/area/tenant groups) + continuous-rollup
specs, validated and lowered to the device tables of ops/rules.py.
``manager`` — the host runtime: installs, dedup-keyed alert emission
through the normal ingest pipeline, rollup reads.
"""

from sitewhere_tpu_torch.rules.manager import RulesManager
from sitewhere_tpu_torch.rules.model import RuleSet, RuleSetError

__all__ = ["RuleSet", "RuleSetError", "RulesManager"]
