"""Mix consoles (port of ``diffmst_tpu/console``)."""

from diffmst_torch.console.console import AdvancedMixConsole, BasicMixConsole, ConsoleOutput

__all__ = ["AdvancedMixConsole", "BasicMixConsole", "ConsoleOutput"]
