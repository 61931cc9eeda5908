"""Object scripting of substrata_tpu_torch: XML object scripts, path
controllers, the Winter language (K16), and the Lua VM with its event
handlers and timers (copies of the reference's host modules)."""

from substrata_tpu_torch.scripting.xml_scripts import parse_xml_script  # noqa: F401
from substrata_tpu_torch.scripting.path_controller import ObjectPathController  # noqa: F401
from substrata_tpu_torch.scripting.winter import (  # noqa: F401
    ObjectScriptsEvaluator, ScriptedObject, WinterParseError, WinterScriptEvaluator)
from substrata_tpu_torch.scripting.events import (  # noqa: F401
    ObjectEventHandlers, ScriptTimerQueue, ScriptVM,
)
