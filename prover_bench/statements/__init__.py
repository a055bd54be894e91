"""Traffic kinds: one module each, named by a traffic file's `kind`.

A module's `Statements(config, traffic, seed, device)` makes statement i's
inputs from the seed (`inputs`; statement -1 warms the program in
set-up), proves and verifies a statement through the program's entry
points (`prove`, `verify`), keeps what the check compares on the host
(`keep`), works the same outputs out again with the plain reference
(`reference`) and compares the two (`compare`); `checks` names each number
`compare` returns with its limit.
"""
