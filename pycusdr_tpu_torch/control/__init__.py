"""Control plane: the XML-RPC management and monitoring server (``rpc``)."""
