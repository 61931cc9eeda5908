"""Object scripting of substrata_tpu_torch: the Winter language (K16)."""

from substrata_tpu_torch.scripting.winter import (  # noqa: F401
    ObjectScriptsEvaluator, ScriptedObject, WinterParseError, WinterScriptEvaluator)
