"""The plain reference renderer: threefry streams, camera, brute closest
hit, materials and the bounce loop in plain PyTorch, with the scenes
rebuilt from their recipes. It imports nothing of the program under
test."""
