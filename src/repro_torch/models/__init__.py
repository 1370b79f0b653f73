"""The LM stack of the port: the config schema (`config`), the layers
(`layers`) and the assembled model (`model`)."""
