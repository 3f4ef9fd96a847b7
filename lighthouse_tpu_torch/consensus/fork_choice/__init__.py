"""Fork choice: proto-array LMD-GHOST + the spec wrapper.

Twin of consensus/proto_array + consensus/fork_choice.
"""

from .proto_array import ProtoArray  # noqa: F401
from .fork_choice import ForkChoice  # noqa: F401
